"""The port's ViT (tf_operator_tpu_torch/models/vit.py, train/vit.py) held
against the JAX package's on the CPU, in f32, on the same weights (the
flax params carried across with models/convert.py) and the same numpy
images.

Tolerances: logits 1e-5 absolute and gradients 1e-4, as
tests/test_torch_bert.py justifies them. The flax parameters are
perturbed from their init before the comparison (cls_token starts at
zero, and so would hide a misplaced cls position), and the patch order
is checked on its own: a port that flattened the patch grid column-major
would still train, but with position_embed on other patches.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import vit as jax_vit
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import vit as torch_vit
from tf_operator_tpu_torch.models.convert import vit_state_dict_from_flax
from tf_operator_tpu_torch.train import vit as torch_vit_cli

OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4
PERTURB = 0.02


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _images(uint8, b=3, seed=0):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    return rng.standard_normal((b, 32, 32, 3)).astype(np.float32)


def _reference(pool, images, labels):
    """(perturbed flax params, logits, loss, gradients) of the reference
    VIT_TINY in f32."""
    cfg = dataclasses.replace(jax_vit.VIT_TINY, pool=pool, dtype=jnp.float32)
    model = jax_vit.ViT(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(images))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + PERTURB * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(images))
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return loss.mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return to_np(params), np.asarray(logits), float(loss), to_np(grads)


def _port(pool, params, remat=False):
    cfg = dataclasses.replace(torch_vit.VIT_TINY, pool=pool, dtype=torch.float32, remat=remat)
    model = torch_vit.ViT(cfg)
    model.load_state_dict(vit_state_dict_from_flax(params))
    return model


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("pool", ["gap", "cls"])
def test_vit_matches_jax(pool, uint8):
    images = _images(uint8)
    labels = np.array([1, 7, 3])
    params, want_logits, want_loss, want_grads = _reference(pool, images, labels)
    model = _port(pool, params)
    logits = model(torch.tensor(images))
    loss = F.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), want_loss, atol=OUT_ATOL)
    want = vit_state_dict_from_flax(want_grads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    assert ("cls_token" in got) == (pool == "cls")
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("pool", ["gap", "cls"])
def test_remat_equals_the_plain_forward_and_backward(pool):
    """--remat recomputes each block in the backward: the same logits and
    the same gradients, bit for bit on the CPU."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(torch_vit.VIT_TINY, pool=pool, dtype=torch.float32)
    plain = torch_vit.ViT(cfg, generator=gen)
    remat = torch_vit.ViT(dataclasses.replace(cfg, remat=True))
    remat.load_state_dict(plain.state_dict())
    images = torch.tensor(_images(False))
    outs = []
    for model in (plain, remat):
        logits = model(images)
        logits.square().sum().backward()
        outs.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for name, grad in outs[0][1].items():
        assert torch.equal(grad, outs[1][1][name]), name


def test_patches_are_flattened_row_major():
    """The token at index i * (W / p) + j is the patch at row i, column j:
    the reference's reshape of its NHWC conv output."""
    cfg = dataclasses.replace(torch_vit.VIT_TINY, dtype=torch.float32, num_layers=0)
    model = torch_vit.ViT(cfg)
    with torch.no_grad():
        model.patch_embed.weight.zero_()
        model.patch_embed.weight[0, 0, 0, 0] = 1.0  # token feature 0 = the patch's corner pixel
        model.position_embed.zero_()
    images = torch.zeros(1, 32, 32, 3)
    for i in range(4):
        for j in range(4):
            images[0, 8 * i, 8 * j, 0] = 10 * i + j
    seen = []
    model.ln_final.register_forward_hook(lambda m, args, out: seen.append(args[0]))
    model(images)
    tokens = seen[0][0, :, 0]
    assert tokens.tolist() == [10 * i + j for i in range(4) for j in range(4)]


def test_config_validation_and_uint8_normalization():
    with pytest.raises(ValueError, match="pool must be 'gap' or 'cls'"):
        torch_vit.ViTConfig(pool="max")
    with pytest.raises(ValueError, match="not divisible"):
        _ = torch_vit.ViTConfig(image_size=30, patch_size=8).num_patches
    assert torch_vit.VIT_B16.num_patches == 196
    assert torch_vit.VIT_B16.block_config().head_dim == 64
    batch = torch_vit.synthetic_batch(torch.Generator().manual_seed(0), 4)
    assert batch["image"].shape == (4, 32, 32, 3) and batch["image"].dtype == torch.float32
    # the same labels draw the same class means
    again = torch_vit.synthetic_batch(torch.Generator().manual_seed(1), 4)
    assert again["image"].shape == batch["image"].shape


def test_cli_runs_on_cpu(tmp_path):
    args = torch_vit_cli.parse_args([
        "--preset", "tiny", "--steps", "4", "--per-chip-batch", "8", "--log-every", "1",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path), "--remat",
    ])
    summary = torch_vit_cli.run(args)
    assert summary["exit_code"] == 0 and summary["step"] == 4
    assert summary["images_per_sec"] > 0 and 0.0 <= summary["accuracy"] <= 1.0
    assert summary["loss"] < summary["first_loss"]
    assert torch_vit_cli.config(args).remat


@pytest.mark.parametrize("argv, item", [
    # --tp is ported (tests/test_torch_tensor_parallel.py trains at tp 2),
    # and since item 4's 2-D line, --fsdp together with it
    (["--tp", "2", "--fsdp", "2"], "item 4"),
])
def test_cli_refuses_what_is_not_ported(argv, item, capsys):
    """Nothing of the CLI's mesh flags is refused any more: each parses to
    the reference's MeshConfig, and nothing names the ROADMAP item."""
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig

    assert torch_vit_cli.parse_args(["--tp", "2"]).mesh.tp == 2
    assert torch_vit_cli.parse_args(argv).mesh == MeshConfig(dp=-1, fsdp=2, tp=2)
    assert item not in capsys.readouterr().err


def test_cli_serves_telemetry_with_monitoring_bind_addr(monkeypatch):
    """--monitoring-bind-addr (ported with the telemetry plane) starts the
    worker's TrainTelemetry around the run and stops it after."""
    from tf_operator_tpu_torch.train import observe

    started = []
    real = observe.TrainTelemetry.start
    monkeypatch.setattr(observe.TrainTelemetry, "start",
                        lambda self, addr: started.append(self) or real(self, "127.0.0.1:0"))
    args = torch_vit_cli.parse_args(["--preset", "tiny", "--steps", "2", "--per-chip-batch",
                                     "4", "--device", "cpu",
                                     "--monitoring-bind-addr", "0.0.0.0:9090"])
    assert torch_vit_cli.run(args)["exit_code"] == 0
    (telemetry,) = started
    assert telemetry.worker == "worker-0" and telemetry._httpd is None
    assert telemetry.healthz()["phase"] == "training"


def test_cli_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_vit_cli.run(torch_vit_cli.parse_args(["--steps", "1"]))
