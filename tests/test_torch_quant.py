"""The port's int8 decode (tf_operator_tpu_torch/ops/quant.py, the int8 KV
cache and the int8 flags of models/gpt.py) held against the JAX package's
on the CPU at GPT_TINY in f32, on the same weights (the flax params carried
across with models/convert.py, the quantized tree with
gpt_int8_state_dict_from_flax).

Tolerances: the quantizers' int8 outputs bit-equal to the reference's on
the same inputs, their scales within one f32 ulp; logits within OUT_ATOL
(1e-5, the f32 differences of two frameworks summing the same products in
other orders through 2 layers); greedy chains equal. A KV cache's int8
values are compared within one step of the int8 grid (KV_Q_ATOL): the
vectors reaching the quantizer differ between the frameworks by those f32
differences, which can cross a rounding boundary; their scales within
KV_SCALE_RTOL. So decode-step logits are compared with both frameworks
reading the same cache bytes (OUT_ATOL), and an int8-KV prefill's logits,
which read the prefill's own quantization, within PREFILL_INT8_ATOL (one
step of the int8 grid moves a logit by up to ~5e-4 here).
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.ops import quant as jax_quant
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import (
    gpt_int8_state_dict_from_flax, gpt_state_dict_from_flax,
)
from tf_operator_tpu_torch.ops import quant as torch_quant
from tf_operator_tpu_torch.ops.attention import DenseGeneral
from tf_operator_tpu_torch.serve import engine as torch_engine
from tf_operator_tpu_torch.train import gpt as torch_gpt_cli
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL = 1e-5
KV_Q_ATOL = 1
KV_SCALE_RTOL = 1e-5
PREFILL_INT8_ATOL = 2e-3

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed")


@pytest.fixture(scope="module")
def weights():
    """(reference f32 cfg, flax params, their quantized tree, port f32
    model) on one set of weights."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    qparams = jax.tree_util.tree_map(np.array, jax_quant.quantize_params(params))
    params = jax.tree_util.tree_map(np.array, params)
    model = torch_gpt.GPT(tcfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return jcfg, params, qparams, model


def _ulp_close(got, want) -> None:
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32), np.asarray(want, np.float32),
                                    maxulp=1)


@needs_jax
@pytest.mark.parametrize("shape, n_contract", [
    ((128, 256), 1),        # mlp_in / lm_head: [in, out]
    ((128, 2, 64), 1),      # a head projection: [in, heads, head_dim]
    ((2, 64, 128), 2),      # attn_out: [heads, head_dim, out]
    ((7, 5), 1),            # a column of zeros takes the 1e-8 floor
])
def test_quantize_kernel_matches_reference(shape, n_contract):
    rng = np.random.default_rng(sum(shape))
    kernel = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    kernel[..., 0] = 0.0
    want_q, want_s = jax_quant.quantize_kernel(jnp.asarray(kernel), n_contract)
    got_q, got_s = torch_quant.quantize_kernel(torch.tensor(kernel), n_contract)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert tuple(got_s.shape) == shape[n_contract:]
    _ulp_close(got_s.numpy(), want_s)


def test_quantize_params_matches_reference(weights):
    """The whole GPT_TINY tree through both transforms: every int8 kernel
    bit-equal, every scale within one ulp and of its group's shape (one
    per (head, column) for the head projections, one per output feature
    for attn_out, mlp_in, mlp_out and lm_head); idempotent; a conv-shaped
    kernel refused in the reference's words."""
    _, params, qparams, _ = weights
    tparams = jax.tree_util.tree_map(torch.tensor, params)
    got = torch_quant.quantize_params(tparams)
    cfg = torch_gpt.GPT_TINY
    heads, head_dim = cfg.num_heads, cfg.head_dim
    shapes = {"query": (heads, head_dim), "key": (heads, head_dim),
              "value": (heads, head_dim), "attn_out": (cfg.hidden_size,),
              "mlp_in": (cfg.intermediate_size,), "mlp_out": (cfg.hidden_size,),
              "lm_head": (cfg.vocab_size,)}
    checked = 0
    for path, want in jax.tree_util.tree_flatten_with_path(qparams)[0]:
        keys = [k.key for k in path]
        node = got
        for key in keys:
            node = node[key]
        if keys[-1] == "kernel" and want.dtype == np.int8:
            np.testing.assert_array_equal(node.numpy(), want, err_msg="/".join(keys))
            checked += 1
        elif keys[-1] == "kernel_scale":
            assert tuple(node.shape) == shapes[keys[-2]], keys
            _ulp_close(node.numpy(), want)
        else:
            np.testing.assert_array_equal(node.numpy(), want)
    assert checked == 6 * cfg.num_layers + 1
    assert torch_quant.is_quantized(got) and not torch_quant.is_quantized(tparams)
    again = torch_quant.quantize_params(got)
    for layer in ("layer_0", "layer_1"):
        assert again[layer]["attention"]["attn_out"]["kernel"] is \
            got[layer]["attention"]["attn_out"]["kernel"]
    conv = {"block": {"conv": {"kernel": torch.ones(3, 3, 4, 8)}}}
    with pytest.raises(ValueError, match="kernel at 'block/conv/kernel' has ndim 4"):
        torch_quant.quantize_params(conv)
    with pytest.raises(ValueError, match="conv-family shape"):
        jax_quant.quantize_params(jax.tree_util.tree_map(jnp.asarray, {"c": {"kernel": np.ones(
            (3, 3, 4, 8), np.float32)}}))


@needs_jax
def test_absmax_quantize_matches_reference():
    """The KV quantizer on [b, n, h, d] vectors (one all-zero vector at
    the floor): int8 bit-equal, scales within one ulp."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 6, 2, 64)) * 2.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    want_q, want_s = jax_gpt._absmax_quantize(jnp.asarray(x))
    got_q, got_s = torch_gpt._absmax_quantize(torch.tensor(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    _ulp_close(got_s.numpy(), want_s)


@needs_jax
@pytest.mark.parametrize("in_shape, out_shape", [
    ((128,), (256,)), ((128,), (2, 64)), ((2, 64), (128,)),
])
def test_quant_dense_general_matches_reference(in_shape, out_shape):
    """QuantDenseGeneral on the reference module's int8 kernel, scale and
    bias, at f32 and in bf16 (the rounding points: product in the
    compute dtype, scale in f32, bias added in the compute dtype)."""
    rng = np.random.default_rng(len(in_shape) * 10 + len(out_shape))
    kernel = (rng.standard_normal(in_shape + out_shape) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(out_shape) * 0.1).astype(np.float32)
    n_in = len(in_shape)
    q, s = jax_quant.quantize_kernel(jnp.asarray(kernel), n_in)
    x = rng.standard_normal((3, 5) + in_shape).astype(np.float32)
    for jdtype, tdtype, atol in ((jnp.float32, torch.float32, OUT_ATOL),
                                 (jnp.bfloat16, torch.bfloat16, 2e-2)):
        mod = jax_quant.QuantDenseGeneral(
            features=out_shape if len(out_shape) > 1 else out_shape[0],
            axis=tuple(range(-n_in, 0)) if n_in > 1 else -1, dtype=jdtype)
        want = mod.apply({"params": {"kernel": q, "kernel_scale": s, "bias": bias}},
                         jnp.asarray(x))
        twin = (torch_quant.quant_head_projection(in_shape[0], *out_shape, tdtype)
                if len(out_shape) == 2 else
                torch_quant.QuantDense(in_shape[0], out_shape[0], tdtype) if n_in == 1 else
                torch_quant.QuantDenseGeneral(in_shape, out_shape, tdtype))
        twin.load_quantized({"kernel": torch.tensor(np.asarray(q)),
                             "kernel_scale": torch.tensor(np.asarray(s)),
                             "bias": torch.tensor(bias)})
        got = twin(torch.tensor(x))
        assert got.dtype == tdtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=atol, rtol=atol)


def test_quantize_model_gives_the_converted_bytes(weights):
    """The port's quantize_model of the converted f32 weights holds the
    bytes the reference's quantize_params wrote (int8 bit-equal, scales
    within one ulp); the twin shares the embeddings and norms with the
    f32 model and holds no f32 kernel; a twin passes through unchanged."""
    _, _, qparams, model = weights
    twin = torch_quant.quantize_model(model)
    want = gpt_int8_state_dict_from_flax(qparams)
    own = twin.state_dict()
    assert set(own) == set(want)
    for name, tensor in want.items():
        if tensor.dtype == torch.int8:
            assert torch.equal(own[name], tensor), name
        elif name.endswith("kernel_scale"):
            _ulp_close(own[name].numpy(), tensor.numpy())
        else:
            assert torch.equal(own[name], tensor), name
    assert twin.token_embed is model.token_embed and twin.ln_final is model.ln_final
    assert twin.layer_0.ln_attn is model.layer_0.ln_attn
    assert not any(isinstance(m, (torch.nn.Linear, DenseGeneral)) for m in twin.modules())
    assert torch_quant.quantize_model(twin) is twin
    assert torch_gpt.weight_bytes(twin) < torch_gpt.weight_bytes(model) / 2
    loaded = torch_quant.quantize_model(torch_gpt.GPT(model.cfg))
    loaded.load_state_dict(want)
    for name, tensor in loaded.state_dict().items():
        assert torch.equal(tensor, want[name]), name


def _ref_logits(jcfg, params, qparams, prompt, new, kv, w):
    """The reference's greedy chain, its prefill logits and its
    teacher-forced decode-step logits along that chain -> (chain, [b, new,
    vocab], the cache after the prefill and after each step)."""
    tree = qparams if w else params
    chain = np.asarray(jax_gpt.generate(jcfg, tree, jnp.asarray(prompt), new,
                                        kv_quant_int8=kv, weights_int8=w))
    b, p = prompt.shape
    total = p + new
    pre = jax_gpt.GPTPrefill(jcfg, cache_len=total, kv_quant_int8=kv, weights_int8=w)
    logits, upd = pre.apply({"params": tree}, jnp.asarray(prompt), mutable=["cache"])
    out, caches = [np.asarray(logits)], [upd["cache"]]
    step = jax_gpt.GPTDecodeStep(jcfg, cache_len=total, kv_quant_int8=kv, weights_int8=w)
    for index in range(p, total - 1):
        logits, upd = step.apply({"params": tree, "cache": caches[-1]},
                                 jnp.asarray(chain[:, index]), jnp.int32(index),
                                 mutable=["cache"])
        caches.append(upd["cache"])
        out.append(np.asarray(logits))
    return chain, np.stack(out, axis=1), caches


def _load_cache(cache, jcache) -> None:
    """Copy a reference cache's contents into a port KVCache in place."""
    for layer in range(len(cache.keys)):
        attn = jcache[f"layer_{layer}"]["attention"]
        pairs = [(cache.keys, "k"), (cache.values, "v")]
        if cache.quantized:
            pairs += [(cache.key_scales, "k_scale"), (cache.value_scales, "v_scale")]
        for tensors, name in pairs:
            tensors[layer].copy_(torch.tensor(np.asarray(attn[name])))


def _kv_close(jcache, cache) -> None:
    """Dense or pooled caches: int8 values within KV_Q_ATOL and scales
    within KV_SCALE_RTOL of the reference's, layer by layer."""
    for layer in range(len(cache.keys)):
        attn = jcache[f"layer_{layer}"]["attention"]
        for name, vals, scales in (("k", cache.keys, cache.key_scales),
                                   ("v", cache.values, cache.value_scales)):
            assert vals[layer].dtype == torch.int8
            diff = np.abs(vals[layer].numpy().astype(np.int32)
                          - np.asarray(attn[name]).astype(np.int32))
            assert diff.max() <= KV_Q_ATOL, (layer, name)
            np.testing.assert_allclose(scales[layer].numpy(), np.asarray(attn[name + "_scale"]),
                                       rtol=KV_SCALE_RTOL, atol=1e-9)


@pytest.mark.parametrize("kv, w", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["bf-kv-f32-w", "int8-kv", "int8-w", "int8-both"])
def test_int8_generate_matches_reference(weights, kv, w):
    """generate at every flag combination: the greedy chain equal to the
    reference's; along that chain every decode step's logits within
    OUT_ATOL of the reference step's when both read the same cache (the
    reference's, loaded before each port step), the prefill's logits
    within OUT_ATOL (PREFILL_INT8_ATOL under int8 KV, where the prefill
    attends over its own quantization of vectors that differ from the
    reference's by f32 noise: one flip of the int8 grid moves a logit by
    up to that); the free-running int8 cache as _kv_close says."""
    jcfg, params, qparams, model = weights
    prompt = np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32)
    new = 10
    chain, want, jcaches = _ref_logits(jcfg, params, qparams, prompt, new, kv, w)
    got_chain = torch_gpt.generate(model, torch.tensor(prompt), new, kv_quant_int8=kv,
                                   weights_int8=w)
    np.testing.assert_array_equal(got_chain.numpy(), chain)
    b, p = prompt.shape
    cache = torch_gpt.KVCache.zeros(model.cfg, b, p + new, kv_quant_int8=kv)
    first = torch_gpt.GPTPrefill(model, weights_int8=w)(torch.tensor(prompt).long(), cache)
    np.testing.assert_allclose(first.numpy(), want[:, 0],
                               atol=PREFILL_INT8_ATOL if kv else OUT_ATOL)
    if kv:
        _kv_close(jcaches[0], cache)
    step = torch_gpt.GPTDecodeStep(model, weights_int8=w)
    for i, index in enumerate(range(p, p + new - 1)):
        _load_cache(cache, jcaches[i])
        got = step(torch.tensor(chain[:, index]).long(), index, cache)
        np.testing.assert_allclose(got.numpy(), want[:, i + 1], atol=OUT_ATOL,
                                   err_msg=f"step at {index}")


def test_int8_prefill_matches_stepwise(weights):
    """Under both int8 flags the uniform path (GPTPrefill writing the
    quantized cache, then attending over what it stored) and the
    all-stepwise path give the same chain and the same cache for the
    prompt, within one int8 step and KV_SCALE_RTOL, so a row's tokens do
    not depend on which phase ingested its prompt."""
    _, _, _, model = weights
    twin = torch_quant.quantize_model(model)
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 512, (3, 8))).long()
    new, total = 8, 16
    prefilled = torch_gpt.generate(twin, prompt, new, kv_quant_int8=True)
    lens = torch.full((3,), 8)
    sample = torch_gpt._sampler(0.0, 0, 1.0, None)
    stepwise = torch.cat([prompt[:, :1], torch_gpt._decode(twin, prompt, lens, total, sample,
                                                           True, kv_quant_int8=True)], dim=1)
    assert torch.equal(prefilled, stepwise)
    a = torch_gpt.KVCache.zeros(twin.cfg, 3, total, kv_quant_int8=True)
    b = torch_gpt.KVCache.zeros(twin.cfg, 3, total, kv_quant_int8=True)
    torch_gpt.GPTPrefill(twin)(prompt, a)
    step = torch_gpt.GPTDecodeStep(twin)
    for index in range(8):
        step(prompt[:, index], index, b)
    for x, y in zip(a.tensors(), b.tensors()):
        if x.dtype == torch.int8:
            assert (x[:, :8].int() - y[:, :8].int()).abs().max() <= KV_Q_ATOL
        else:
            np.testing.assert_allclose(x[:, :8].numpy(), y[:, :8].numpy(), rtol=KV_SCALE_RTOL)


def _grid(seed, n, total, lens):
    rng = np.random.default_rng(seed)
    prompt = np.zeros((n, total), np.int32)
    for i, length in enumerate(lens):
        prompt[i, :length] = rng.integers(0, 512, length)
    return prompt, np.asarray(lens, np.int32)


def test_slot_steps_with_both_flags_match_reference(weights):
    """SlotDecodeStep and PagedSlotDecodeStep with kv_quant_int8 and
    weights_int8 over a ragged 3-row grid for 12 steps: next tokens equal
    the reference's steps on its quantized tree each step; the paged
    pool holds the dense cache's int8 bytes and scales exactly, position
    for position (the reference's test_paged_int8_matches_dense_int8);
    the pools' bytes count the scales."""
    jcfg, _, qparams, model = weights
    n, total, bs, nb = 3, 32, 8, 13
    prompt, lens = _grid(0, n, total, [5, 9, 1])
    tables = (np.random.default_rng(1).permutation(np.arange(1, nb))[:n * 4]
              .reshape(n, 4).astype(np.int32))
    flags = dict(kv_quant_int8=True, weights_int8=True)
    jdense = jax_gpt.SlotDecodeStep(jcfg, n, total, **flags)
    jd = jdense.init_cache()
    dense = torch_gpt.SlotDecodeStep(model, n, total, **flags)
    paged = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb, **flags)
    assert isinstance(dense.model.lm_head, torch_quant.QuantDenseGeneral)
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    for i in range(12):
        jd, want = jdense(qparams, jd, tok, index, prompt, lens)
        got = dense(tok, index, prompt, lens).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"step {i}")
        np.testing.assert_array_equal(paged(tok, index, prompt, lens, tables).numpy(), got)
        tok, index = got.astype(np.int32), index + 1
    _kv_close(jd, dense.cache)
    for d, p in zip(dense.cache.tensors(), paged.cache.tensors()):
        for row in range(n):
            logical = p[torch.as_tensor(tables[row]).long()].reshape(total, *p.shape[2:])
            assert torch.equal(logical[:12], d[row, :12])
    kv_elems = 2 * 2 * n * total * 2 * 64
    assert dense.kv_bytes_total == kv_elems + 2 * 2 * n * total * 2 * 4


def test_copy_block_copies_the_scales(weights):
    """An int8 pool: a prefill chunk into a slot's first block, then
    copy_block into another: every layer's k, v and both scale pools of
    the copy equal the source's (a copy-on-write prefix block with stale
    scales would decode garbage), and the pool matches the reference's
    after each program."""
    jcfg, _, qparams, model = weights
    n, total, bs, nb = 2, 32, 8, 9
    flags = dict(kv_quant_int8=True, weights_int8=True)
    jstep = jax_gpt.PagedSlotDecodeStep(jcfg, n, total, bs, nb, **flags)
    jcache = jstep.init_cache()
    step = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb, **flags)
    table = np.array([3, 5, 0, 0], np.int32)
    tokens = np.random.default_rng(6).integers(0, 512, (1, 8)).astype(np.int32)
    jcache = jstep.prefill(qparams, jcache, tokens, 0, table)
    step.prefill(tokens, 0, table)
    jcache = jstep.copy_block(jcache, 3, 7)
    step.copy_block(3, 7)
    assert len(step.cache.tensors()) == 4 * model.cfg.num_layers
    for t in step.cache.tensors():
        assert torch.equal(t[7], t[3]) and float(t[3].abs().float().sum()) > 0
    _kv_close(jcache, step.cache)
    assert (step.prefill_compiles, step.copy_compiles) == (1, 1)


def test_engine_int8_modes_and_swap_requantizes(weights):
    """The engine with both int8 flags: chains equal to the reference
    engine's on its quantized tree and to the port's inline generate
    with the flags; the step reads the int8 twin; swap_params of an f32
    state re-quantizes it into the twin in place (the buffers keep their
    addresses and then hold quantize_model's bytes of the new weights)."""
    jcfg, _, qparams, model = weights
    from tf_operator_tpu.serve import engine as jax_engine

    jobs = [(list(range(1, 12)), 5), ([9, 4, 2], 6), (list(range(20, 44)), 4)]
    kw = dict(n_slots=2, block_size=8, prefill_chunk=6, kv_quant_int8=True, weights_int8=True)
    ref = jax_engine.ContinuousBatchingEngine(jcfg, qparams, start=False, **kw)
    port = torch_engine.ContinuousBatchingEngine(model, start=False, device="cpu", **kw)
    outs = []
    for eng in (ref, port):
        handles = [eng.submit(row, new) for row, new in jobs]
        while not all(h.done.is_set() for h in handles):
            eng._admit()
            eng._evict_cancelled()
            if eng.active_slots:
                eng._work_once()
        outs.append([h.result(1) for h in handles])
    assert outs[0] == outs[1]
    for (row, new), chain in zip(jobs, outs[1]):
        assert chain == torch_gpt.generate(model, torch.tensor([row]), new, kv_quant_int8=True,
                                           weights_int8=True)[0].tolist()
    assert port.step.model is port.model
    assert isinstance(port.model.layer_0.mlp_in, torch_quant.QuantDenseGeneral)
    other = torch_gpt.GPT(model.cfg, generator=torch.Generator().manual_seed(9))
    kernel = port.model.layer_0.attention.query.kernel
    address = kernel.data_ptr()
    port.drain()
    port.swap_params(other.state_dict())
    port.resume_admission()
    assert kernel.data_ptr() == address
    want = torch_quant.quantize_model(other).state_dict()
    for name, tensor in port.model.state_dict().items():
        assert torch.equal(tensor, want[name]), name
    port.stop()


def test_gpt_cli_generates_with_both_int8_flags():
    """train/gpt.py --generate 4 --weights-int8 --kv-int8 on the CPU: the
    decoded chain is the trained model's int8 generate."""
    args = torch_gpt_cli.parse_args([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2", "--seq-len", "64",
        "--generate", "4", "--weights-int8", "--kv-int8", "--device", "cpu"])
    summary, state = torch_gpt_cli.train(args)
    prompt = torch.tensor(summary["generated"])[:, :torch_gpt_cli.PROMPT_LEN]
    want = torch_gpt.generate(state.model, prompt, 4, kv_quant_int8=True, weights_int8=True)
    assert summary["generated"] == want.tolist()
    assert summary["generate_ms_per_token"] > 0
