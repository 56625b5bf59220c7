"""The port's ResNet BatchNorm options (models/resnet.py norm_impl and
norm_dtype, models/norm.py FlaxBatchNorm, models/convert.py's BatchNorm_i
names) held against the JAX package's on the same numpy inputs.

- FlaxBatchNorm against flax.linen.BatchNorm as the reference's ResNet
  builds it (momentum 0.9, epsilon 1e-5, f32 parameters), f32: the output,
  the gradients of sum(y * g) and the batch_stats, in train and eval mode.
- norm_dtype=bf16 on an f32 input, both BatchNorms against the reference's
  at the same dtype: the output within one bf16 ulp, the statistics at
  f32's tolerance.
- A small ResNet (tests/test_torch_resnet.py's SMALL) with
  norm_impl="flax", f32, from the reference's param tree (its
  BottleneckBlock_i/BatchNorm_j, loaded by name through the converter):
  logits, loss, every gradient, the updated batch_stats and the eval
  logits after them; and at norm_dtype=bf16 on both norm_impls, the
  logits within a bf16 bound.
- Sync over a world of 2 gloo processes (this file run as a script,
  `_world_main`): each rank FlaxBatchNorm on its half of the batch with
  sync_group set, against the reference's BatchNorm over the whole batch.

Tolerances are tests/test_torch_resnet.py's (f32: outputs and statistics
1e-5, gradients 1e-4 with 1e-5 relative).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import resnet as torch_resnet
from tf_operator_tpu_torch.models.convert import resnet_state_dict_from_flax
from tf_operator_tpu_torch.models.norm import FlaxBatchNorm, TpuBatchNorm
from tf_operator_tpu_torch.parallel import distributed

from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL = 1e-5
STATS_ATOL = 1e-5
GRAD_ATOL = 1e-4
GRAD_RTOL = 1e-5
# one bf16 ulp at |y|: 2^-7 relative (8 significant bits), and a floor
# for outputs near 0
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 2.0 ** -14
WORLD = 2
SMALL = dict(stage_sizes=(1, 2), num_classes=10, width=64)
BATCH, SIZE = 4, 32


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def bn_case(seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, 6, 6, 32)) * 3.0 + 1.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(32)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(32)).astype(np.float32)
    var = (1.0 + 0.2 * rng.random(32)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, mean, var, g


def port_bn(cls, scale, bias, mean, var, dtype=torch.float32):
    bn = cls(scale.shape[0], dtype=dtype)
    bn.load_state_dict({"scale": torch.tensor(scale), "bias": torch.tensor(bias),
                        "mean": torch.tensor(mean), "var": torch.tensor(var)})
    return bn


def reference_bn(impl, x, scale, bias, mean, var, g, train, dtype="float32"):
    """The reference's BatchNorm as its ResNet builds it (`impl` "flax":
    nn.BatchNorm, "tpu": TpuBatchNorm) on x: output, gradients of
    sum(y * g) by x, scale and bias, and the batch_stats after."""
    import jax
    import jax.numpy as jnp
    from flax import linen as flax_nn

    from tf_operator_tpu.models import norm as jax_norm

    cls = flax_nn.BatchNorm if impl == "flax" else jax_norm.TpuBatchNorm
    module = cls(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                 dtype=getattr(jnp, dtype), param_dtype=jnp.float32)
    stats = {"mean": mean, "var": var}

    def loss(params, xx):
        y, upd = module.apply({"params": params, "batch_stats": stats}, xx,
                              mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": scale, "bias": bias}, jnp.asarray(x))
    new = upd["batch_stats"] if train else stats
    return {"y": np.asarray(y.astype(jnp.float32)), "gx": np.asarray(gx),
            "scale": np.asarray(gp["scale"]), "bias": np.asarray(gp["bias"]),
            "mean": np.asarray(new["mean"]), "var": np.asarray(new["var"])}


@pytest.mark.parametrize("train", [True, False])
def test_flax_batchnorm_matches_flax(train):
    """Output, input/scale/bias gradients of sum(y * g), and the running
    statistics after the call (updated in train mode, untouched in eval)."""
    x, scale, bias, mean, var, g = bn_case()
    want = reference_bn("flax", x, scale, bias, mean, var, g, train)
    bn = port_bn(FlaxBatchNorm, scale, bias, mean, var)
    bn.train(train)
    xt = _nchw(x).requires_grad_()
    out = bn(xt)
    assert out.dtype == torch.float32
    (out * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), want["y"], atol=OUT_ATOL)
    for got, key in ((_nhwc(xt.grad), "gx"), (bn.scale.grad.numpy(), "scale"),
                     (bn.bias.grad.numpy(), "bias")):
        np.testing.assert_allclose(got, want[key], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=key)
    np.testing.assert_allclose(bn.mean.numpy(), want["mean"], atol=STATS_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), want["var"], atol=STATS_ATOL)


@pytest.mark.parametrize("impl", ["flax", "tpu"])
def test_norm_dtype_bf16_matches_the_reference(impl):
    """norm_dtype=bf16 on an f32 activation: the output rounds to bf16
    within one ulp of the reference's (flax: one rounding of an f32
    result; TpuBatchNorm's bf16 multiply-add, whose product may round
    before the add: one ulp at the output's largest magnitude), the
    statistics stay f32."""
    x, scale, bias, mean, var, g = bn_case(9)
    want = reference_bn(impl, x, scale, bias, mean, var, g, True, dtype="bfloat16")
    cls = FlaxBatchNorm if impl == "flax" else TpuBatchNorm
    bn = port_bn(cls, scale, bias, mean, var, dtype=torch.bfloat16)
    out = bn(_nchw(x))
    assert out.dtype == torch.bfloat16
    got = _nhwc(out)
    atol = BF16_ATOL if impl == "flax" else BF16_RTOL * float(np.abs(want["y"]).max())
    np.testing.assert_allclose(got, want["y"], rtol=BF16_RTOL, atol=atol)
    np.testing.assert_allclose(bn.mean.numpy(), want["mean"], atol=STATS_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), want["var"], atol=STATS_ATOL)


# --- the small ResNet against the reference --------------------------------


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _perturb_bn(tree, rng):
    """BatchNorm scales around 1 and biases around 0 (a zero last scale
    would cut every residual branch off the gradient check)."""
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
def _jax_reference(norm_impl: str, norm_dtype: str = ""):
    """The reference ResNet (SMALL, f32) at norm_impl and norm_dtype:
    params, batch, logits, loss, gradients, updated batch_stats and the
    eval logits after them."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import resnet as jax_resnet

    model = jax_resnet.ResNet(**SMALL, dtype=jnp.float32, norm_impl=norm_impl,
                              norm_dtype=getattr(jnp, norm_dtype) if norm_dtype else None)
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
        (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x)
        eval_logits = model.apply({"params": params, "batch_stats": new_stats}, x, train=False)
        return loss, logits, new_stats, grads, eval_logits

    loss, logits, new_stats, grads, eval_logits = train_then_eval(params, jnp.asarray(x))
    return {"x": x, "labels": labels, "params": params, "stats": stats,
            "logits": np.asarray(logits), "loss": float(loss), "grads": _np_tree(grads),
            "new_stats": _np_tree(new_stats), "eval_logits": np.asarray(eval_logits)}


def test_converter_loads_the_flax_batchnorm_tree_by_name():
    ref = _jax_reference("flax")
    block = ref["params"]["BottleneckBlock_0"]
    assert {"BatchNorm_0", "BatchNorm_1", "BatchNorm_2", "proj_bn"} <= set(block)
    assert "TpuBatchNorm_0" not in block
    state = resnet_state_dict_from_flax(ref["params"], ref["stats"])
    assert torch.equal(state["BottleneckBlock_0.BatchNorm_1.scale"],
                       torch.tensor(block["BatchNorm_1"]["scale"]))
    assert torch.equal(state["BottleneckBlock_1.BatchNorm_2.var"],
                       torch.tensor(ref["stats"]["BottleneckBlock_1"]["BatchNorm_2"]["var"]))
    model = torch_resnet.ResNet(**SMALL, dtype=torch.float32, norm_impl="flax")
    assert isinstance(model.BottleneckBlock_0.BatchNorm_0, FlaxBatchNorm)
    assert isinstance(model.stem_bn, FlaxBatchNorm)
    model.load_state_dict(state)  # strict: every name maps
    with pytest.raises(ValueError, match="norm_impl"):
        torch_resnet.ResNet(**SMALL, norm_impl="layer")


def test_small_resnet_flax_norm_matches_jax():
    ref = _jax_reference("flax")
    model = torch_resnet.ResNet(**SMALL, dtype=torch.float32, norm_impl="flax")
    model.load_state_dict(resnet_state_dict_from_flax(ref["params"], ref["stats"]))
    model.train()
    logits = model(torch.tensor(ref["x"]))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(ref["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=OUT_ATOL)
    want_grads = resnet_state_dict_from_flax(ref["grads"], {})
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), want.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert got["BottleneckBlock_2.Conv_1.weight"].grad.abs().max() > 1e-3
    want_stats = resnet_state_dict_from_flax({}, ref["new_stats"])
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want_stats)
    for name, want in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), atol=STATS_ATOL,
                                   err_msg=name)
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.tensor(ref["x"]))
    np.testing.assert_allclose(eval_logits.numpy(), ref["eval_logits"], atol=OUT_ATOL)


@pytest.mark.parametrize("norm_impl", ["flax", "tpu"])
def test_small_resnet_norm_dtype_bf16_matches_jax(norm_impl):
    """An f32 ResNet whose BatchNorms compute in bf16: each norm's output
    rounds to bf16 (so each block's activations are bf16 after it) on both
    sides; the logits agree within a bound of a few bf16 ulps of their
    scale, and differ from the f32 model's (the option takes effect)."""
    ref = _jax_reference(norm_impl, "bfloat16")
    model = torch_resnet.ResNet(**SMALL, dtype=torch.float32, norm_impl=norm_impl,
                                norm_dtype=torch.bfloat16)
    model.load_state_dict(resnet_state_dict_from_flax(ref["params"], ref["stats"]))
    assert model.stem_bn.dtype == torch.bfloat16
    model.train()
    with torch.no_grad():
        logits = model(torch.tensor(ref["x"])).numpy()
    bound = 4 * BF16_RTOL * float(np.abs(ref["logits"]).max())
    np.testing.assert_allclose(logits, ref["logits"], atol=bound)
    f32 = torch_resnet.ResNet(**SMALL, dtype=torch.float32, norm_impl=norm_impl)
    f32.load_state_dict(resnet_state_dict_from_flax(ref["params"], ref["stats"]))
    with torch.no_grad():
        full = f32(torch.tensor(ref["x"])).numpy()
    assert float(np.abs(full - logits).max()) > 1e-3


# --- sync over a world of two ---------------------------------------------------


def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    torch.set_num_threads(1)
    try:
        x, scale, bias, mean, var, g = bn_case()
        rank = distributed.rank()
        rows = slice(rank * x.shape[0] // WORLD, (rank + 1) * x.shape[0] // WORLD)
        bn = port_bn(FlaxBatchNorm, scale, bias, mean, var)
        bn.sync_group = torch.distributed.group.WORLD
        bn.train()
        xt = _nchw(x[rows]).requires_grad_()
        out = bn(xt)
        (out * _nchw(g[rows])).sum().backward()
        grads = {k: distributed.all_reduce(v, torch.distributed.group.WORLD)
                 for k, v in (("scale", bn.scale.grad), ("bias", bn.bias.grad))}
        torch.save({"rank": rank, "rows": (rows.start, rows.stop), "y": _nhwc(out),
                    "gx": _nhwc(xt.grad), "mean": bn.mean.numpy(), "var": bn.var.numpy(),
                    **{k: v.numpy() for k, v in grads.items()}},
                   os.path.join(work, f"rank{rank}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


def test_flax_batchnorm_syncs_over_a_world_of_two(tmp_path):
    """Each rank's half of the batch, its statistics all-reduced: the
    outputs, the input gradients of its rows, the summed scale and bias
    gradients and the running statistics are the reference's over the
    whole batch (its GSPMD mean over the sharded batch axis)."""
    from tests import test_torch_tensor_parallel as tpt

    x, scale, bias, mean, var, g = bn_case()
    want = reference_bn("flax", x, scale, bias, mean, var, g, True)
    ranks = tpt.run_world(os.path.abspath(__file__), str(tmp_path), WORLD)
    for out in ranks:
        rows = slice(*out["rows"])
        np.testing.assert_allclose(out["y"], want["y"][rows], atol=OUT_ATOL)
        np.testing.assert_allclose(out["gx"], want["gx"][rows], atol=GRAD_ATOL, rtol=GRAD_RTOL)
        for key in ("scale", "bias"):
            np.testing.assert_allclose(out[key], want[key], atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(out["mean"], want["mean"], atol=STATS_ATOL)
        np.testing.assert_allclose(out["var"], want["var"], atol=STATS_ATOL)


if __name__ == "__main__":
    _world_main(sys.argv[1])
