"""The port's trainer core (tf_operator_tpu_torch/train/) held against the
JAX package's, plus the port's isolation from JAX.

- One AdamW step of BERT_TINY in f32 from the same weights and numpy
  batch: loss 1e-5 and updated parameters 1e-5 absolute (1% of the
  first AdamW step, which moves a weight by lr * g / (|g| + eps), about
  lr = 1e-3). Where |g| is within a few hundred eps of zero that ratio
  is set by f32 rounding noise, not by the math: the attention key
  bias, whose exact gradient is zero (it shifts every score of a row by
  q.b, which the softmax ignores), and the odd weight of another
  tensor. Those weights (|g| <= 1e-6; at least 99% of the weights with
  a nonzero gradient lie above it) are held to moving at most
  lr * (1 + 1e-3) + lr * wd * |w|.
  At the bench's weight decay of 0.01 the decay term lr * wd * |w| is at
  most 1e-5 (a LayerNorm scale of 1), within that tolerance, so the step
  is also taken at wd 0.5, where the decay moves weights by up to 5e-4
  and a dropped or mis-scaled decay cannot pass.
- Two SGD-momentum steps of a small f32 ResNet (the xla route, width
  8, one stage) from the same weights and numpy batch against the JAX Trainer with
  optax.sgd(lr, momentum=0.9), the reference's ResNet optimizer: the
  momentum only shows from the second step. Losses 1e-5, parameters
  1e-5 (the gradients agree to 1e-4 and lr is 0.1), BatchNorm running
  statistics 1e-5; then `evaluate` in eval mode (running statistics)
  against the JAX Trainer's.
- The port imports with jax, flax, optax, orbax and tf_operator_tpu
  blocked, and no module of it or chip_smoke.py imports them.
"""

import ast
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import bert as jax_bert
from tf_operator_tpu.models import resnet as jax_resnet
from tf_operator_tpu.parallel.mesh import single_device_mesh
from tf_operator_tpu.parallel.sharding import CONV_RULES
from tf_operator_tpu.train import trainer as jax_trainer
from tf_operator_tpu_torch._device import resolve_device
from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models import resnet as torch_resnet
from tf_operator_tpu_torch.models.convert import (
    bert_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from tf_operator_tpu_torch.ops import kernels
from tf_operator_tpu_torch.train import bert as torch_bert_cli
from tf_operator_tpu_torch.train import resnet as torch_resnet_cli
from tf_operator_tpu_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tf_operator_tpu_torch")
LR = 1e-3
ATOL = 1e-5
GRAD_NOISE = 1e-6
BLOCKED = ("jax", "flax", "optax", "orbax", "tf_operator_tpu")


def _numpy_batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 20:] = 0
    weights = ((rng.random((b, s)) < 0.3) & (mask > 0)).astype(np.float32)
    return {"input_ids": ids, "labels": ids, "mlm_weights": weights,
            "attention_mask": mask}


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["labels"] = out["labels"].long()
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@functools.lru_cache(maxsize=None)
def _jax_step(weight_decay):
    """Weights before and after one JAX Trainer.step, and its loss."""
    cfg = dataclasses.replace(jax_bert.BERT_TINY, dtype=jnp.float32)
    model = jax_bert.BertForMLM(cfg)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.mlm_task(model),
        optax.adamw(LR, weight_decay=weight_decay), mesh=single_device_mesh(),
    )
    batch = _numpy_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    before = _np_tree(state.params)
    ev = trainer.evaluate(state, trainer.place_batch(jbatch))
    eval_loss = float(ev["loss"])
    state, metrics = trainer.step(state, trainer.place_batch(jbatch))
    return {
        "batch": batch, "before": before, "after": _np_tree(state.params),
        "loss": float(metrics["loss"]), "eval_loss": eval_loss,
    }


@pytest.fixture(scope="module")
def jax_run():
    return _jax_step(0.01)


def _port_trainer(before, packed=False, attention_fn=None, weight_decay=0.01):
    cfg = dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)
    model = torch_bert.BertForMLM(cfg, attention_fn=attention_fn)
    model.load_state_dict(bert_state_dict_from_flax(before))
    trainer = torch_trainer.Trainer(
        model, torch_trainer.mlm_task(), learning_rate=LR,
        weight_decay=weight_decay, packed=packed, device="cpu",
    )
    return trainer, trainer.init()


@pytest.mark.parametrize("weight_decay", [0.01, 0.5])
def test_one_step_matches_jax(weight_decay):
    jax_run = _jax_step(weight_decay)
    trainer, state = _port_trainer(jax_run["before"], weight_decay=weight_decay)
    batch = trainer.place_batch(_torch_batch(jax_run["batch"]))
    state, metrics = trainer.step(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["loss"], atol=ATOL)
    want = bert_state_dict_from_flax(jax_run["after"])
    before = bert_state_dict_from_flax(jax_run["before"])
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    strict = nonzero = 0
    for name, w in want.items():
        p = got[name].detach()
        g = got[name].grad
        noise = g.abs() <= GRAD_NOISE
        strict += int((~noise).sum())
        nonzero += int((g != 0).sum())
        np.testing.assert_allclose(
            p[~noise].numpy(), w[~noise].numpy(), atol=ATOL, err_msg=name
        )
        moved = (p[noise] - before[name][noise]).abs()
        limit = LR * (1 + 1e-3) + LR * weight_decay * before[name][noise].abs()
        assert bool((moved <= limit).all()), name
    assert strict >= 0.99 * nonzero


def test_evaluate_matches_jax(jax_run):
    trainer, state = _port_trainer(jax_run["before"])
    metrics = trainer.evaluate(state, trainer.place_batch(_torch_batch(jax_run["batch"])))
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["eval_loss"], atol=ATOL)
    assert state.step == 0
    assert all(p.grad is None for p in state.model.parameters())


def test_packed_drops_the_mask(jax_run):
    """packed: place_batch drops attention_mask, as the JAX trainer's
    _prepare_batch does, so the flash route runs with no mask."""
    batch = _torch_batch(jax_run["batch"])
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.packed, jt.shard_sequence = True, False
    assert set(jt._prepare_batch(jax_run["batch"])) == {"input_ids", "labels", "mlm_weights"}
    seen = []

    def recording_attention(q, k, v, mask=None):
        seen.append(mask)
        from tf_operator_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, mask)

    trainer, state = _port_trainer(jax_run["before"], packed=True,
                                   attention_fn=recording_attention)
    placed = trainer.place_batch(batch)
    assert set(placed) == {"input_ids", "labels", "mlm_weights"}
    trainer.step(state, placed)
    assert seen and all(m is None for m in seen)
    unpacked, ustate = _port_trainer(jax_run["before"], attention_fn=recording_attention)
    seen.clear()
    unpacked.step(ustate, unpacked.place_batch(batch))
    assert seen and all(m is not None and m.shape == (2, 1, 1, 64) for m in seen)


@pytest.mark.parametrize("warmup", [0, 3])
def test_warmup_cosine_lr_matches_optax(warmup):
    port = torch_trainer.warmup_cosine_lr(1e-3, 10, warmup)
    ref = jax_trainer.warmup_cosine_lr(1e-3, 10, warmup)
    for count in range(14):
        want = float(ref(count)) if callable(ref) else ref
        got = port(count) if callable(port) else port
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("extra", [[], ["--flash", "--packed", "--warmup-steps", "1"]])
def test_cli_main_runs_on_cpu(extra):
    before = dict(kernels.LAUNCHES)
    rc = torch_bert_cli.main([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2",
        "--seq-len", "32", "--device", "cpu", *extra,
    ])
    assert rc == 0
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel


def test_cli_run_summary():
    summary = torch_bert_cli.run(torch_bert_cli.parse_args([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2",
        "--seq-len", "16", "--device", "cpu", "--flash",
    ]))
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["eval_loss"])
    assert summary["forward_passes"] == 3 and summary["backward_passes"] == 2


SGD_LR = 0.1
SGD_STEPS = 2
RESNET_SMALL = dict(stage_sizes=(1,), num_classes=10, width=8)


@functools.lru_cache(maxsize=None)
def _jax_sgd_run():
    """Weights before, after each of two JAX Trainer.steps with
    optax.sgd(lr, momentum=0.9), the step losses, and an evaluate after."""
    model = jax_resnet.ResNet(**RESNET_SMALL, dtype=jnp.float32)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.classification_task(model),
        optax.sgd(SGD_LR, momentum=0.9), mesh=single_device_mesh(), rules=CONV_RULES,
    )
    rng = np.random.default_rng(4)
    batch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (4,)).astype(np.int32)}
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    run = {"batch": batch, "params": [_np_tree(state.params)],
           "stats": [_np_tree(state.batch_stats)], "loss": []}
    for _ in range(SGD_STEPS):
        state, metrics = trainer.step(state, jbatch)
        run["loss"].append(float(metrics["loss"]))
        run["params"].append(_np_tree(state.params))
        run["stats"].append(_np_tree(state.batch_stats))
    ev = trainer.evaluate(state, jbatch)
    run["eval"] = {k: float(v) for k, v in ev.items()}
    return run


@pytest.fixture(scope="module")
def sgd_run():
    return _jax_sgd_run()


def _port_resnet_trainer(run):
    model = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32)
    model.load_state_dict(resnet_state_dict_from_flax(run["params"][0], run["stats"][0]))
    trainer = torch_trainer.Trainer(
        model, torch_trainer.classification_task(), learning_rate=SGD_LR,
        device="cpu", optimizer="sgd",
    )
    batch = trainer.place_batch({
        "image": torch.tensor(run["batch"]["image"]),
        "label": torch.tensor(run["batch"]["label"]).long(),
    })
    return trainer, trainer.init(), batch


def test_sgd_momentum_steps_match_optax(sgd_run):
    trainer, state, batch = _port_resnet_trainer(sgd_run)
    for i in range(SGD_STEPS):
        state, metrics = trainer.step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), sgd_run["loss"][i], atol=ATOL)
        want = resnet_state_dict_from_flax(sgd_run["params"][i + 1], sgd_run["stats"][i + 1])
        got = state.model.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=ATOL,
                                       err_msg=f"step {i + 1} {name}")
    assert state.step == SGD_STEPS
    # the second step is not plain SGD: without momentum it would land elsewhere
    moved = [
        (sgd_run["params"][2]["Dense_0"]["kernel"] - sgd_run["params"][1]["Dense_0"]["kernel"]),
        (sgd_run["params"][1]["Dense_0"]["kernel"] - sgd_run["params"][0]["Dense_0"]["kernel"]),
    ]
    assert np.abs(moved[0] - moved[1]).max() > 1e-3


def test_classification_evaluate_matches_jax(sgd_run):
    trainer, state, batch = _port_resnet_trainer(sgd_run)
    for _ in range(SGD_STEPS):
        state, _ = trainer.step(state, batch)
    stats = {k: v.clone() for k, v in state.model.named_buffers()}
    metrics = trainer.evaluate(state, batch)
    assert not state.model.training
    np.testing.assert_allclose(float(metrics["loss"]), sgd_run["eval"]["loss"], atol=ATOL)
    np.testing.assert_allclose(
        float(metrics["accuracy"]), sgd_run["eval"]["accuracy"], atol=1e-6
    )
    for name, value in state.model.named_buffers():
        assert torch.equal(value, stats[name]), name  # eval reads, never updates


def test_trainer_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="optimizer"):
        torch_trainer.Trainer(torch.nn.Linear(2, 2), None, device="cpu", optimizer="lamb")


@pytest.mark.parametrize("conv3_impl", ["xla", "pallas"])
def test_resnet_cli_runs_on_cpu(conv3_impl):
    before = dict(kernels.LAUNCHES)
    rc = torch_resnet_cli.main([
        "--small", "--steps", "2", "--per-chip-batch", "4", "--image-size", "32",
        "--device", "cpu", "--conv3-impl", conv3_impl, "--warmup-steps", "1",
    ])
    assert rc == 0
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel


def test_resnet_cli_run_summary():
    args = torch_resnet_cli.parse_args([
        "--small", "--steps", "2", "--per-chip-batch", "2", "--image-size", "32",
        "--device", "cpu", "--conv3-impl", "pallas",
    ])
    summary = torch_resnet_cli.run(args)
    assert np.isfinite(summary["loss"]) and summary["images_per_sec"] > 0
    assert summary["forward_passes"] == 2 and summary["backward_passes"] == 2
    model, classes = torch_resnet_cli.build_model(args, torch.Generator().manual_seed(0))
    assert classes == 10
    assert isinstance(model.BottleneckBlock_0.Conv_1, torch_resnet.PallasConv3x3)


def test_device_defaults_to_cuda_and_raises_without_it():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def _port_modules():
    names = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                names.append(name[: -len(".__init__")] if name.endswith(".__init__") else name)
    return sorted(names)


def test_port_imports_with_jax_blocked():
    modules = _port_modules()
    assert "tf_operator_tpu_torch.ops.flash_attention" in modules
    assert "tf_operator_tpu_torch.ops.conv_bn" in modules
    assert "tf_operator_tpu_torch.models.resnet" in modules
    for name in ("api.types", "parallel.distributed", "parallel.mesh", "parallel.sharding",
                 "testing.rendezvous_worker", "train.smoke", "api.k8s", "api.serde",
                 "api.validation", "api.defaults", "runtime.substrate", "runtime.control",
                 "runtime.events", "runtime.expectations", "runtime.workqueue",
                 "controller.status", "controller.serve", "serve.fleet", "serve.autoscaler",
                 "serve.observatory", "telemetry.collector", "telemetry.__main__",
                 "parallel.pipeline", "models.moe_pipeline", "testing.dryrun"):
        assert f"tf_operator_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_module_of_the_port_imports_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            offenders += [f"{path}:{node.lineno} {t}" for t in tops if t in BLOCKED]
    assert len(paths) > 10
    assert offenders == []
