"""The port's BERT (tf_operator_tpu_torch/models/bert.py) held against the
JAX package's on BERT_TINY in f32: the flax params are carried across
with models/convert.py, the same numpy batch goes through both, and
logits, MLM loss and every parameter's gradient must agree, with the
plain attention route and with the flash route (JAX's Pallas kernels
in interpret mode on the CPU, the port's kernels' plain versions).

Tolerances (f32): logits and loss 1e-5 absolute: the two frameworks
sum the same products in other orders through 2 layers and a 1024-wide
head, so they agree to a few f32 ulps of values near 1-10, not to the
2e-6 of a single attention call. Gradients 1e-4 absolute, the
reference's own gradient tolerance (tests/test_attention.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import bert as jax_bert
from tf_operator_tpu.ops import losses as jax_losses
from tf_operator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models.convert import bert_state_dict_from_flax
from tf_operator_tpu_torch.ops import flash_attention as torch_fa
from tf_operator_tpu_torch.ops import losses as torch_losses

OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _configs(num_heads):
    jcfg = dataclasses.replace(
        jax_bert.BERT_TINY, dtype=jnp.float32, num_heads=num_heads
    )
    tcfg = dataclasses.replace(
        torch_bert.BERT_TINY, dtype=torch.float32, num_heads=num_heads
    )
    return jcfg, tcfg


def _batch(cfg, b=2, s=128, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([s, s - 45])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    weights = ((rng.random((b, s)) < 0.3) & (mask > 0)).astype(np.float32)
    return ids, mask, weights


def _as_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize(
    "route,num_heads",
    [("plain", 4), ("flash", 4), ("flash", 2)],
    ids=["plain", "flash-hd32", "flash-hd64"],
)
def test_bert_tiny_matches_jax(route, num_heads):
    """num_heads 2 gives head_dim 64, where the JAX flash route runs its
    Pallas kernels (at 32 both packages fall back to plain attention)."""
    jcfg, tcfg = _configs(num_heads)
    ids, mask, weights = _batch(jcfg)
    jmodel = jax_bert.BertForMLM(
        jcfg, attention_fn=jax_flash if route == "flash" else None
    )
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))[
        "params"
    ]

    def jloss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
        return jax_bert.mlm_loss(logits, jnp.asarray(ids), jnp.asarray(weights)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tmodel = torch_bert.BertForMLM(
        tcfg, attention_fn=torch_fa.flash_attention if route == "flash" else None
    )
    tmodel.load_state_dict(bert_state_dict_from_flax(_as_numpy_tree(params)))
    tids = torch.tensor(ids, dtype=torch.long)
    tlogits = tmodel(tids, torch.tensor(mask))
    tl = torch_bert.mlm_loss(tlogits, tids, torch.tensor(weights))
    tl.backward()

    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=OUT_ATOL)
    np.testing.assert_allclose(tl.item(), float(jl), atol=OUT_ATOL)
    want = bert_state_dict_from_flax(_as_numpy_tree(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(
            got[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL, err_msg=name
        )


def test_bf16_forward_is_close_to_jax():
    """The default dtype policy (bf16 compute, f32 LayerNorm, bf16
    logits) on the same weights: bf16 logits agree to a few bf16
    roundings (2^-8 relative) of their largest magnitude."""
    jcfg = jax_bert.BERT_TINY
    tcfg = torch_bert.BERT_TINY
    ids, mask, _ = _batch(jcfg, seed=4)
    jmodel = jax_bert.BertForMLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask))["params"]
    jlogits = np.asarray(
        jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), np.float32
    )
    tmodel = torch_bert.BertForMLM(tcfg)
    tmodel.load_state_dict(bert_state_dict_from_flax(_as_numpy_tree(params)))
    with torch.no_grad():
        tlogits = tmodel(torch.tensor(ids, dtype=torch.long), torch.tensor(mask))
    assert tlogits.dtype == torch.bfloat16
    scale = np.abs(jlogits).max()
    np.testing.assert_allclose(tlogits.float().numpy(), jlogits, atol=4 * 2.0**-8 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    """Loss and d_logits of the fused cross-entropy, and the weighted
    mean's max(sum(w), 1) floor (all-zero weights give 0, not NaN).
    bf16 d_logits agree to one bf16 rounding (2^-8 relative)."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((6, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (6,)).astype(np.int32)
    weights = (rng.random(6) < 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jl, jg = jax.value_and_grad(
        lambda x: jax_losses.weighted_mean_xent(x, jnp.asarray(labels), jnp.asarray(weights))
    )(jnp.asarray(logits, jdt))
    tx = torch.tensor(logits).to(tdt).requires_grad_()
    tl = torch_losses.weighted_mean_xent(tx, torch.tensor(labels), torch.tensor(weights))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5)
    np.testing.assert_allclose(
        tx.grad.float().numpy(), np.asarray(jg, np.float32),
        atol=1e-6 if dtype == "float32" else 2.0**-8,
    )
    zero = torch_losses.weighted_mean_xent(
        torch.tensor(logits), torch.tensor(labels), torch.zeros(6)
    )
    assert float(zero) == 0.0


def test_converter_raises_on_unknown_key():
    params = {"encoder": {"layer_0": {"attention": {"query": {"kernel": np.zeros((4, 2, 2))}}}}}
    assert set(bert_state_dict_from_flax(params)) == {
        "encoder.layer_0.attention.query.kernel"
    }
    params["encoder"]["layer_0"]["adapter"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="adapter"):
        bert_state_dict_from_flax(params)


def test_converter_transposes_dense_kernels():
    kernel = np.arange(6, dtype=np.float32).reshape(2, 3)  # flax [in, out]
    state = bert_state_dict_from_flax({"mlm_head": {"kernel": kernel, "bias": np.zeros(3)}})
    np.testing.assert_array_equal(state["mlm_head.weight"].numpy(), kernel.T)
    assert state["mlm_head.bias"].shape == (3,)


def test_init_follows_flax_distributions():
    """Dense kernels lecun-normal (std 1/sqrt(fan_in)), embeddings
    std 1/sqrt(features), zero biases, unit LayerNorm scale; one seed
    gives one set of weights."""
    cfg = torch_bert.BERT_TINY
    model = torch_bert.BertForMLM(cfg, generator=torch.Generator().manual_seed(0))
    again = torch_bert.BertForMLM(cfg, generator=torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        torch.testing.assert_close(p, q, atol=0.0, rtol=0.0, msg=name)
    h = cfg.hidden_size
    layer = model.encoder.layer_0
    assert abs(layer.mlp_in.weight.std().item() * h**0.5 - 1.0) < 0.05
    assert abs(layer.attention.query.kernel.std().item() * h**0.5 - 1.0) < 0.05
    assert layer.mlp_in.weight.abs().max() <= 2.0 / 0.87962566103423978 / h**0.5 + 1e-6
    assert abs(model.encoder.token_embed.weight.std().item() * h**0.5 - 1.0) < 0.05
    assert float(layer.attention.query.bias.detach().abs().max()) == 0.0
    assert float(layer.ln_attn.weight.detach().min()) == 1.0


def test_remat_gives_the_same_gradients():
    """cfg.remat recomputes each block in the backward
    (torch.utils.checkpoint, the reference's nn.remat): same loss and
    gradients as keeping the activations, exactly, on the flash route."""
    _, tcfg = _configs(2)
    ids, mask, weights = _batch(tcfg, s=64)
    grads = []
    for remat in (False, True):
        model = torch_bert.BertForMLM(
            dataclasses.replace(tcfg, remat=remat),
            attention_fn=torch_fa.flash_attention,
            generator=torch.Generator().manual_seed(0),
        )
        tids = torch.tensor(ids, dtype=torch.long)
        torch_bert.mlm_loss(
            model(tids, torch.tensor(mask)), tids, torch.tensor(weights)
        ).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=0.0, rtol=0.0, msg=name)
