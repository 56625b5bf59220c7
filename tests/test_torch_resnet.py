"""The port's ResNet (tf_operator_tpu_torch/models/resnet.py and norm.py)
held against the JAX package's, on the same numpy inputs and weights.

- TpuBatchNorm: train output, updated running statistics, eval output
  and gradients, as tests/test_workload.py holds the reference's.
- flax's SAME padding on stride 2 (pads (0, 1)) for the conv and the
  -inf-padded max-pool, conv7_to_s2d_kernel and the s2d stem, and the
  uint8 normalisation (bit-equal in bf16).
- A small ResNet (width 64, so the 3x3 convs take conv3x3_s1; stage
  sizes (1, 2), so a stride-1 block exists beyond stage 0 and a
  stride-2 block falls back to the torch conv; N=4 at 32x32, f32) with
  the flax params carried across by models/convert.py, on both conv
  routes: "xla" against the reference's "xla", "pallas" (the kernels'
  plain versions on the CPU) against "pallas_interpret". Logits, loss,
  every parameter's gradient, the updated running statistics and the
  eval-mode logits after them.

The BatchNorm scales and biases are drawn at random on both sides
before the comparison: at init the last BN of each block has scale 0,
which zeroes every gradient inside the residual branch, conv3x3_s1's
included, and would make the gradient check vacuous.

Tolerances (f32): logits, loss and BN outputs 1e-5 absolute, running
statistics 1e-5, gradients 1e-4, the reference's own gradient tolerance
(tests/test_attention.py), with 1e-5 relative beside it for the
BatchNorm scale gradients, sums of hundreds of terms that reach ~100.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from tf_operator_tpu.models import norm as jax_norm
from tf_operator_tpu.models import resnet as jax_resnet
from tf_operator_tpu_torch.models import resnet as torch_resnet
from tf_operator_tpu_torch.models.convert import resnet_state_dict_from_flax
from tf_operator_tpu_torch.models.norm import TpuBatchNorm
from tf_operator_tpu_torch.ops import kernels

OUT_ATOL = 1e-5
STATS_ATOL = 1e-5
GRAD_ATOL = 1e-4
GRAD_RTOL = 1e-5


def _nchw(x: np.ndarray) -> torch.Tensor:
    """numpy NHWC -> torch NCHW in channels_last memory."""
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


# --- TpuBatchNorm ----------------------------------------------------------


@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((16, 6, 6, 32)) * 3.0 + 1.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(32)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(32)).astype(np.float32)
    var = (1.0 + 0.2 * rng.random(32)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, mean, var, g


def _port_bn(scale, bias, mean, var):
    bn = TpuBatchNorm(scale.shape[0], dtype=torch.float32)
    bn.load_state_dict({
        "scale": torch.tensor(scale), "bias": torch.tensor(bias),
        "mean": torch.tensor(mean), "var": torch.tensor(var),
    })
    return bn


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(bn_case, train):
    """Output, input/scale/bias gradients of sum(y * g), and the running
    statistics after the call (updated in train mode, untouched in
    eval mode)."""
    x, scale, bias, mean, var, g = bn_case
    module = jax_norm.TpuBatchNorm(use_running_average=not train, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def loss(params, xx):
        y, upd = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              xx, mutable=["batch_stats"])
        return (y * g).sum(), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x)
    )
    bn = _port_bn(scale, bias, mean, var)
    bn.train(train)
    xt = _nchw(x).requires_grad_()
    out = bn(xt)
    assert out.is_contiguous(memory_format=torch.channels_last)
    (out * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(y), atol=OUT_ATOL)
    for got, want in ((_nhwc(xt.grad), gx), (bn.scale.grad.numpy(), gp["scale"]),
                      (bn.bias.grad.numpy(), gp["bias"])):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    stats = upd["batch_stats"] if train else variables["batch_stats"]
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]), atol=STATS_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]), atol=STATS_ATOL)


def test_batchnorm_keeps_the_biased_variance(bn_case):
    """The running variance takes the biased batch variance, not torch
    BatchNorm2d's unbiased one: the two differ by n / (n - 1)."""
    x, scale, bias, _, _, _ = bn_case
    bn = _port_bn(scale, bias, np.zeros(32, np.float32), np.zeros(32, np.float32))
    bn.train()
    bn(_nchw(x))
    biased = x.reshape(-1, 32).astype(np.float64).var(axis=0)
    np.testing.assert_allclose(bn.var.numpy(), 0.1 * biased, rtol=1e-4)


# --- padding, pooling, stems, normalisation --------------------------------


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("kernel_size,strides", [((3, 3), (2, 2)), ((1, 1), (2, 2)),
                                                 ((3, 3), (1, 1))])
def test_same_conv_matches_flax(size, kernel_size, strides):
    """flax SAME: (0, 1) on a 3x3 stride-2 window over an even size."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    k = rng.standard_normal((*kernel_size, 8, 16)).astype(np.float32)
    conv = flax_nn.Conv(16, kernel_size, strides, padding="SAME", use_bias=False)
    want = conv.apply({"params": {"kernel": k}}, x)
    got = torch_resnet.conv2d(_nchw(x), torch.tensor(k).permute(3, 2, 0, 1), strides, "SAME")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    if size == 8 and kernel_size == (3, 3) and strides == (2, 2):
        assert torch_resnet.same_padding(size, 3, 2) == (0, 1)


@pytest.mark.parametrize("size", [112, 9])
def test_max_pool_matches_flax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32) - 3.0
    want = flax_nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got = torch_resnet.max_pool_same(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_conv7_to_s2d_kernel_matches_jax():
    rng = np.random.default_rng(11)
    w7 = rng.standard_normal((7, 7, 3, 16)).astype(np.float32)
    want = jax_resnet.conv7_to_s2d_kernel(jnp.asarray(w7))
    got = torch_resnet.conv7_to_s2d_kernel(torch.tensor(w7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_s2d_stem_reparameterizes_conv7():
    """The 4x4/s1 conv over the space-to-depth input with the mapped
    kernel reproduces the 7x7/s2 stem (tests/test_workload.py's check,
    on the port's functions)."""
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    w7 = torch.tensor(rng.standard_normal((7, 7, 3, 16)).astype(np.float32))
    ref = torch_resnet.conv2d(x.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1), (2, 2),
                              ((3, 3), (3, 3)))
    s2d = torch_resnet.space_to_depth(x, 2)
    np.testing.assert_array_equal(
        s2d.numpy(), np.asarray(jax_resnet.space_to_depth(jnp.asarray(x.numpy()), 2))
    )
    w4 = torch_resnet.conv7_to_s2d_kernel(w7)
    got = torch_resnet.conv2d(s2d.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1), (1, 1),
                              ((2, 1), (2, 1)))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_uint8_normalisation_matches_jax(dtype):
    """(x.astype(dtype) - 127.5) * (1 / 127.5), bit for bit."""
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = (jnp.asarray(x).astype(getattr(jnp, dtype)) - 127.5) * (1.0 / 127.5)
    got = torch_resnet.normalize_uint8(torch.tensor(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


def test_synthetic_uint8_batch_matches_jax():
    want = jax_resnet.synthetic_uint8_batch(3, 2, 8, 10)
    got = torch_resnet.synthetic_uint8_batch(3, 2, 8, 10)
    np.testing.assert_array_equal(got["image"].numpy(), want["image"])
    np.testing.assert_array_equal(got["label"].numpy(), want["label"])


def test_converter_raises_on_unknown_path():
    params = {"stem": {"kernel": np.zeros((7, 7, 3, 8), np.float32)},
              "BottleneckBlock_0": {"BatchNorm_0": {"scale": np.ones(8, np.float32)}}}
    with pytest.raises(KeyError, match="BatchNorm_0"):
        resnet_state_dict_from_flax(params, {})
    with pytest.raises(KeyError, match="Conv_9"):
        resnet_state_dict_from_flax(
            {"BottleneckBlock_0": {"Conv_9": {"kernel": np.zeros((1, 1, 8, 8))}}}, {}
        )


# --- the small ResNet against the reference --------------------------------

SMALL = dict(stage_sizes=(1, 2), num_classes=10, width=64)
BATCH, SIZE = 4, 32


def _perturb_bn(tree, rng):
    """BatchNorm scales around 1 and biases around 0, drawn with rng, so
    that no residual branch is cut off by a zero scale."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb_bn(value, rng)
        elif key == "scale":
            out[key] = (1.0 + 0.3 * rng.standard_normal(value.shape)).astype(np.float32)
        elif key == "bias":
            out[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
        else:
            out[key] = value
    return out


@functools.lru_cache(maxsize=None)
def _jax_reference(conv3_impl: str, stem: str = "conv7"):
    """Params, batch, logits, loss, gradients, updated batch_stats and
    eval logits after them, from the JAX ResNet."""
    model = jax_resnet.ResNet(**SMALL, dtype=jnp.float32, conv3_impl=conv3_impl, stem=stem)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (BATCH,)).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb_bn(_np_tree(variables["params"]), np.random.default_rng(1))
    stats = _np_tree(variables["batch_stats"])

    def loss_fn(params, x):
        logits, upd = model.apply({"params": params, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy(logits, jax.nn.one_hot(labels, 10)).mean()
        return loss, (logits, upd["batch_stats"])

    @jax.jit
    def train_then_eval(params, x):
        # one compilation for both passes: the test's time is XLA's compile
        (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x
        )
        eval_logits = model.apply({"params": params, "batch_stats": new_stats}, x, train=False)
        return loss, logits, new_stats, grads, eval_logits

    loss, logits, new_stats, grads, eval_logits = train_then_eval(params, jnp.asarray(x))
    return {
        "x": x, "labels": labels, "params": params, "stats": stats,
        "logits": np.asarray(logits), "loss": float(loss), "grads": _np_tree(grads),
        "new_stats": _np_tree(new_stats), "eval_logits": np.asarray(eval_logits),
    }


@pytest.mark.parametrize("conv3_impl,jax_impl,stem", [
    ("xla", "xla", "conv7"),
    ("pallas", "pallas_interpret", "conv7"),
    ("xla", "xla", "s2d"),
])
def test_small_resnet_matches_jax(conv3_impl, jax_impl, stem, monkeypatch):
    ref = _jax_reference(jax_impl, stem)
    model = torch_resnet.ResNet(**SMALL, dtype=torch.float32, conv3_impl=conv3_impl, stem=stem)
    model.load_state_dict(resnet_state_dict_from_flax(ref["params"], ref["stats"], conv3_impl))
    views = []
    real = torch_resnet.conv3x3_s1

    def recording_conv(x, kernel):
        views.append((tuple(x.shape), x.is_contiguous()))
        return real(x, kernel)

    monkeypatch.setattr(torch_resnet, "conv3x3_s1", recording_conv)
    before = dict(kernels.LAUNCHES)
    model.train()
    logits = model(torch.tensor(ref["x"]))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(ref["labels"]).long())
    loss.backward()
    assert kernels.LAUNCHES == before  # CPU tensors take the plain versions
    if conv3_impl == "pallas":
        # blocks 0 (8x8x64) and 2 (4x4x128) take the kernel route, each
        # with a contiguous NHWC view (no copy); block 1 is stride 2
        assert views == [((BATCH, 8, 8, 64), True), ((BATCH, 4, 4, 128), True)]
    else:
        assert views == []
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=OUT_ATOL)
    want_grads = resnet_state_dict_from_flax(ref["grads"], {}, conv3_impl)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, want in want_grads.items():
        assert got[name].grad is not None, name
        np.testing.assert_allclose(
            got[name].grad.numpy(), want.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
            err_msg=name,
        )
    conv1 = "BottleneckBlock_2.Conv_1." + ("kernel" if conv3_impl == "pallas" else "weight")
    assert got[conv1].grad.abs().max() > 1e-3  # the branch is not cut off
    want_stats = resnet_state_dict_from_flax({}, ref["new_stats"], conv3_impl)
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want_stats)
    for name, want in want_stats.items():
        np.testing.assert_allclose(
            buffers[name].numpy(), want.numpy(), atol=STATS_ATOL, err_msg=name
        )
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.tensor(ref["x"]))
    np.testing.assert_allclose(eval_logits.numpy(), ref["eval_logits"], atol=OUT_ATOL)
