"""The port's GPT (tf_operator_tpu_torch/models/gpt.py, train/gpt.py)
held against the JAX package's on the CPU, in f32, on the same weights
(the flax params carried across with models/convert.py) and the same
numpy tokens.

Tolerances: logits and loss 1e-5 absolute and gradients 1e-4, as
tests/test_torch_bert.py justifies them (two frameworks summing the same
products in other orders through 2 layers and a 512-wide head). Runs at
seq 128, where the reference's flash route takes its Pallas kernels (in
interpret mode on the CPU; it leaves them for XLA unless seq % 128 ==
0) and the port's takes its kernels' plain versions.

Greedy chains are held equal to the reference's in f32 only, and every
such test first asserts that the top-2 logit margin at each decision
is far above f32 noise, so that a near-tie cannot make it flaky.

The cuda-marked test needs a card; on a machine with a card and no JAX
run it with `python -m pytest --noconftest tests/test_torch_gpt.py -m cuda`.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.ops.attention import dot_product_attention as jax_dpa
    from tf_operator_tpu.parallel.mesh import single_device_mesh
    from tf_operator_tpu.train import trainer as jax_trainer
except ImportError:  # a card machine without JAX runs only the cuda test
    jax = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.ops import flash_attention as torch_fa
from tf_operator_tpu_torch.ops import kernels
from tf_operator_tpu_torch.train import gpt as torch_gpt_cli
from tf_operator_tpu_torch.train import trainer as torch_trainer
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4
LR = 1e-3
GRAD_NOISE = 1e-6
# the smallest top-2 logit gap a chain test accepts at a decision: far
# above the f32 differences (~1e-6) between the two frameworks
MIN_MARGIN = 1e-4
# GPT_TINY (head_dim 64) and a head_dim-128 variant
VARIANTS = {
    "hd64": {},
    "hd128": dict(hidden_size=256, num_heads=2, intermediate_size=512),
}


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _configs(variant="hd64"):
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32, **VARIANTS[variant])
    tcfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32, **VARIANTS[variant])
    return jcfg, tcfg


def _tokens(cfg, b=2, s=128, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _jax_plain_causal(q, k, v, mask=None):
    s = q.shape[1]
    causal = (jnp.arange(s)[:, None] >= jnp.arange(s)[None, :])[None, None]
    return jax_dpa(q, k, v, causal)


def _jax_params(jcfg, seed=0):
    ids = jnp.asarray(_tokens(jcfg, s=16))
    return _np_tree(jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(seed), ids)["params"])


def _port_model(tcfg, params, attention_fn=None):
    model = torch_gpt.GPT(tcfg, attention_fn=attention_fn)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return model


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("route", ["flash", "plain"])
def test_gpt_matches_jax(route, variant, monkeypatch):
    """Logits, loss and every gradient; on the flash route both sides run
    their flash seam (the port's through its kernels' plain versions,
    once per layer)."""
    jcfg, tcfg = _configs(variant)
    ids = _tokens(jcfg)
    jmodel = jax_gpt.GPT(jcfg, attention_fn=None if route == "flash" else _jax_plain_causal)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]

    def jloss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(ids))
        return jax_gpt.causal_lm_loss(logits, jnp.asarray(ids)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    calls = []
    forward = torch_fa.flash_forward
    monkeypatch.setattr(
        torch_fa, "flash_forward", lambda *a: calls.append(1) or forward(*a)
    )
    tmodel = _port_model(
        tcfg, _np_tree(params),
        None if route == "flash" else torch_gpt.plain_causal_attention,
    )
    tids = torch.tensor(ids, dtype=torch.long)
    tlogits = tmodel(tids)
    tl = torch_gpt.causal_lm_loss(tlogits, tids)
    tl.backward()
    assert len(calls) == (tcfg.num_layers if route == "flash" else 0)

    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=OUT_ATOL)
    np.testing.assert_allclose(tl.item(), float(jl), atol=OUT_ATOL)
    want = gpt_state_dict_from_flax(_np_tree(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(
            got[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL, err_msg=name
        )


@pytest.mark.usefixtures("needs_jax")
def test_causal_lm_loss_weights_match_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 40)) * 2).astype(np.float32)
    ids = rng.integers(0, 40, (2, 9)).astype(np.int32)
    weights = (rng.random((2, 9)) < 0.6).astype(np.float32)
    for w in (None, weights):
        want = jax_gpt.causal_lm_loss(
            jnp.asarray(logits), jnp.asarray(ids), None if w is None else jnp.asarray(w)
        )
        got = torch_gpt.causal_lm_loss(
            torch.tensor(logits), torch.tensor(ids).long(), None if w is None else torch.tensor(w)
        )
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_adamw_step(weight_decay):
    """Weights before and after one JAX Trainer.step of GPT_TINY in f32
    with optax.adamw (train/gpt.py's optimizer), and its loss."""
    jcfg, _ = _configs()
    model = jax_gpt.GPT(jcfg)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.causal_lm_task(model),
        optax.adamw(LR, weight_decay=weight_decay), mesh=single_device_mesh(),
    )
    ids = _tokens(jcfg, seed=5)
    jbatch = {"input_ids": jnp.asarray(ids)}
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    before = _np_tree(state.params)
    state, metrics = trainer.step(state, trainer.place_batch(jbatch))
    return ids, before, _np_tree(state.params), float(metrics["loss"])


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("weight_decay", [0.01, 0.5])
def test_one_adamw_step_matches_optax(weight_decay):
    """train/gpt.py's step (AdamW, weight decay 0.01) against the JAX
    Trainer with optax.adamw; at wd 0.5 a dropped decay cannot pass.
    Parameters 1e-5, with near-zero gradients held to a bound on how
    far they move, as tests/test_torch_trainer.py explains."""
    ids, before, after, jloss = _jax_adamw_step(weight_decay)
    _, tcfg = _configs()
    model = _port_model(tcfg, before)
    trainer = torch_trainer.Trainer(
        model, torch_trainer.causal_lm_task(), learning_rate=LR,
        weight_decay=weight_decay, device="cpu",
    )
    state = trainer.init()
    state, metrics = trainer.step(
        state, trainer.place_batch({"input_ids": torch.tensor(ids).long()})
    )
    np.testing.assert_allclose(float(metrics["loss"]), jloss, atol=OUT_ATOL)
    want = gpt_state_dict_from_flax(after)
    start = gpt_state_dict_from_flax(before)
    strict = nonzero = 0
    for name, param in state.model.named_parameters():
        p, g = param.detach(), param.grad
        noise = g.abs() <= GRAD_NOISE
        strict += int((~noise).sum())
        nonzero += int((g != 0).sum())
        np.testing.assert_allclose(
            p[~noise].numpy(), want[name][~noise].numpy(), atol=OUT_ATOL, err_msg=name
        )
        moved = (p[noise] - start[name][noise]).abs()
        assert bool((moved <= LR * (1 + 1e-3) + LR * weight_decay * start[name][noise].abs()).all())
    assert strict >= 0.99 * nonzero


@pytest.mark.usefixtures("needs_jax")
def test_converter_maps_every_param_once():
    """Every flax leaf lands on one port parameter with its values (Dense
    kernels transposed, DenseGeneral layouts kept), the state_dict loads
    strictly, and an unknown path (BERT's, or a new leaf) raises."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    state = gpt_state_dict_from_flax(params)
    model = torch_gpt.GPT(tcfg)
    model.load_state_dict(state, strict=True)
    assert len(state) == len(jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(
        model.lm_head.weight.detach().numpy(), params["lm_head"]["kernel"].T
    )
    np.testing.assert_array_equal(
        model.layer_1.attention.query.kernel.detach().numpy(),
        params["layer_1"]["attention"]["query"]["kernel"],
    )
    np.testing.assert_array_equal(
        model.position_embed.weight.detach().numpy(), params["position_embed"]["embedding"]
    )
    with pytest.raises(KeyError, match="encoder"):
        gpt_state_dict_from_flax({"encoder": {"ln_final": {"scale": np.ones(4)}}})
    params["layer_0"]["adapter"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="adapter"):
        gpt_state_dict_from_flax(params)


def test_synthetic_batch_is_a_corrupted_markov_walk():
    """About 81% of next tokens follow the successor table (neither end
    of the pair among the 10% corrupted), the table comes from seed 7
    whatever the stream, and one seed gives one batch."""
    cfg = torch_gpt.GPT_TINY
    batch = torch_gpt.synthetic_batch(torch.Generator().manual_seed(1), 8, 512, cfg)
    ids = batch["input_ids"]
    assert ids.shape == (8, 512) and ids.dtype == torch.long
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size
    successor = torch_gpt.successor_table(cfg)
    follows = (ids[:, 1:] == successor[ids[:, :-1]]).float().mean().item()
    want = (1 - torch_gpt.CORRUPT_RATE) ** 2
    assert abs(follows - want) < 0.03, follows
    again = torch_gpt.synthetic_batch(torch.Generator().manual_seed(1), 8, 512, cfg)
    assert torch.equal(again["input_ids"], ids)
    other = torch_gpt.synthetic_batch(torch.Generator().manual_seed(2), 8, 512, cfg)
    assert not torch.equal(other["input_ids"], ids)
    assert torch.equal(torch_gpt.successor_table(cfg), successor)


@pytest.mark.usefixtures("needs_jax")
def test_reference_batch_has_the_same_structure():
    """The reference's synthetic_batch, read the same way, follows its
    own table at the same rate (the draws themselves differ)."""
    jcfg = jax_gpt.GPT_TINY
    ids = np.asarray(jax_gpt.synthetic_batch(jax.random.PRNGKey(1), 8, 512, jcfg)["input_ids"])
    successor = np.asarray(
        jax.random.randint(jax.random.PRNGKey(7), (jcfg.vocab_size,), 0, jcfg.vocab_size)
    )
    follows = float((ids[:, 1:] == successor[ids[:, :-1]]).mean())
    assert abs(follows - (1 - torch_gpt.CORRUPT_RATE) ** 2) < 0.03, follows


def _jax_zero_cache(jcfg, batch, cache_len, index):
    dstep = jax_gpt.GPTDecodeStep(jcfg, cache_len=cache_len)
    shapes = jax.eval_shape(
        lambda: dstep.init(jax.random.PRNGKey(0), jnp.zeros((batch,), jnp.int32), index)["cache"]
    )
    return dstep, jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-index", "per-row-index"])
def test_decode_step_matches_jax(per_row):
    """Teacher-forced GPTDecodeStep logits and the caches it leaves,
    against the reference's on the same weights; per_row gives each row
    its own positions (row 1 walks the cache backwards)."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    seq = _tokens(jcfg, b=2, s=10, seed=2)
    n = seq.shape[1]
    index0 = jnp.zeros((2,), jnp.int32) if per_row else jnp.int32(0)
    dstep, jcache = _jax_zero_cache(jcfg, 2, n, index0)
    cache = torch_gpt.KVCache.zeros(tcfg, 2, n)
    step = torch_gpt.GPTDecodeStep(model)
    for i in range(n):
        index = np.array([i, n - 1 - i], np.int32) if per_row else i
        jlogits, updates = dstep.apply(
            {"params": params, "cache": jcache}, jnp.asarray(seq[:, i]),
            jnp.asarray(index), mutable=["cache"],
        )
        jcache = updates["cache"]
        tlogits = step(
            torch.tensor(seq[:, i]).long(),
            torch.tensor(index).long() if per_row else index, cache,
        )
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=OUT_ATOL,
                                   err_msg=f"position {i}")
    for layer in range(tcfg.num_layers):
        attn = jcache[f"layer_{layer}"]["attention"]
        np.testing.assert_allclose(cache.keys[layer].numpy(), np.asarray(attn["k"]), atol=OUT_ATOL)
        np.testing.assert_allclose(cache.values[layer].numpy(), np.asarray(attn["v"]), atol=OUT_ATOL)


@pytest.mark.usefixtures("needs_jax")
def test_prefill_matches_jax():
    """GPTPrefill: the last position's logits and the cache positions
    [0, p) it writes (the rest stays zero), against the reference's."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    prompt = _tokens(jcfg, b=2, s=8, seed=3)
    jlogits, updates = jax_gpt.GPTPrefill(jcfg, cache_len=12).apply(
        {"params": params}, jnp.asarray(prompt), mutable=["cache"]
    )
    cache = torch_gpt.KVCache.zeros(tcfg, 2, 12)
    tlogits = torch_gpt.GPTPrefill(model)(torch.tensor(prompt).long(), cache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=OUT_ATOL)
    for layer in range(tcfg.num_layers):
        attn = updates["cache"][f"layer_{layer}"]["attention"]
        for got, name in ((cache.keys[layer], "k"), (cache.values[layer], "v")):
            np.testing.assert_allclose(got.numpy(), np.asarray(attn[name]), atol=OUT_ATOL)
            assert float(got[:, 8:].abs().max()) == 0.0


def _decision_margins(model, chain, first_decision):
    """Top-2 logit gaps of the teacher-forced decode step along `chain`
    [b, n], at the decisions for positions >= first_decision[row]."""
    b, n = chain.shape
    cache = torch_gpt.KVCache.zeros(model.cfg, b, n)
    step = torch_gpt.GPTDecodeStep(model)
    gaps = []
    for i in range(n - 1):
        logits = step(chain[:, i], i, cache)
        top2 = torch.topk(logits, 2, dim=-1).values
        for row in range(b):
            if i + 1 >= first_decision[row]:
                gaps.append(float(top2[row, 0] - top2[row, 1]))
    return gaps


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("lens", [None, (4, 7)], ids=["uniform", "ragged"])
def test_greedy_chains_match_jax(lens):
    """Greedy generate, port against reference, f32: the uniform batch
    takes both packages' prefill path, the ragged one (right-padded
    with junk) their all-stepwise path."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=4)
    model = _port_model(tcfg, params)
    prompt = _tokens(jcfg, b=2, s=7, seed=6)
    if lens is not None:
        prompt[0, lens[0]:] = 499
    new = 6
    got = torch_gpt.generate(
        model, torch.tensor(prompt).long(), new,
        prompt_lens=None if lens is None else torch.tensor(lens),
    )
    gaps = _decision_margins(model, got, lens or (7, 7))
    assert min(gaps) > MIN_MARGIN, min(gaps)
    want = jax_gpt.generate(
        jcfg, params, jnp.asarray(prompt), max_new_tokens=new,
        prompt_lens=None if lens is None else jnp.asarray(lens),
    )
    assert got.shape == (2, 7 + new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.usefixtures("needs_jax")
def test_prefill_chain_matches_stepwise_chain():
    """The uniform path (GPTPrefill, then one step per new token) and the
    all-stepwise path on the same prompt: the same chain, and the same
    cache contents for the prompt."""
    jcfg, tcfg = _configs()
    model = _port_model(tcfg, _jax_params(jcfg, seed=7))
    prompt = torch.tensor(_tokens(jcfg, b=3, s=8, seed=8)).long()
    new = 8
    prefilled = torch_gpt.generate(model, prompt, new)
    assert min(_decision_margins(model, prefilled, (8, 8, 8))) > MIN_MARGIN
    lens = torch.full((3,), 8)
    stepwise = torch.cat([
        prompt[:, :1],
        torch_gpt._decode(model, prompt, lens, 8 + new, torch_gpt._sampler(0.0, 0, 1.0, None), True),
    ], dim=1)
    assert torch.equal(prefilled, stepwise)
    pre_cache = torch_gpt.KVCache.zeros(tcfg, 3, 8)
    torch_gpt.GPTPrefill(model)(prompt, pre_cache)
    step_cache = torch_gpt.KVCache.zeros(tcfg, 3, 8)
    step = torch_gpt.GPTDecodeStep(model)
    for i in range(8):
        step(prompt[:, i], i, step_cache)
    for a, b in zip(pre_cache.keys + pre_cache.values, step_cache.keys + step_cache.values):
        torch.testing.assert_close(a, b, atol=OUT_ATOL, rtol=0.0)


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("top_k,top_p", [
    (0, 1.0), (1, 1.0), (5, 1.0), (50, 1.0), (60, 1.0),
    (0, 0.7), (0, 0.05), (5, 0.7), (12, 0.95),
])
def test_filter_logits_matches_jax(top_k, top_p):
    """Ties included: logits on a grid of 0.5 put several tokens at the
    k-th value and at the nucleus boundary."""
    rng = np.random.default_rng(top_k * 100 + int(top_p * 100))
    logits = (np.round(rng.standard_normal((4, 50)) * 4) / 2).astype(np.float32)
    want = np.asarray(jax_gpt._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = torch_gpt._filter_logits(torch.tensor(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def _sampled(model, prompt, seed, **kw):
    return torch_gpt.generate(
        model, prompt, 8, temperature=kw.pop("temperature", 1.0),
        generator=torch.Generator().manual_seed(seed), **kw,
    )


def test_sampled_decode_respects_filters_and_seed():
    """top_k=1 at any temperature is greedy; every token drawn under
    top_k=3 or top_p=0.3 lies in the filtered set of its teacher-forced
    logits; one seed gives one chain, two seeds two."""
    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    model = torch_gpt.GPT(cfg, generator=torch.Generator().manual_seed(3))
    prompt = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(4))
    greedy = torch_gpt.generate(model, prompt, 8)
    assert torch.equal(_sampled(model, prompt, 1, temperature=5.0, top_k=1), greedy)
    for kw in (dict(top_k=3), dict(top_p=0.3), dict(top_k=5, top_p=0.5)):
        chain = _sampled(model, prompt, 2, temperature=1.5, **kw)
        cache = torch_gpt.KVCache.zeros(cfg, 3, chain.shape[1])
        step = torch_gpt.GPTDecodeStep(model)
        for i in range(chain.shape[1] - 1):
            logits = step(chain[:, i], i, cache)
            if i + 1 < prompt.shape[1]:
                continue
            keep = torch.isfinite(torch_gpt._filter_logits(
                logits / 1.5, kw.get("top_k", 0), kw.get("top_p", 1.0)))
            assert bool(keep.gather(1, chain[:, i + 1:i + 2]).all()), (kw, i)
    a, b, c = (_sampled(model, prompt, seed) for seed in (11, 11, 12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :5], prompt) and not torch.equal(a, greedy)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(max_new_tokens=0), ValueError, "max_new_tokens"),
    (dict(max_new_tokens=200), ValueError, "max_seq_len"),
    (dict(top_k=-1), ValueError, "top_k"),
    (dict(top_p=0.0), ValueError, "top_p"),
    (dict(top_p=1.5), ValueError, "top_p"),
    (dict(prompt_lens=torch.tensor([4])), ValueError, "prompt_lens"),
    (dict(prompt_lens=torch.tensor([0, 4])), ValueError, "prompt_lens"),
    (dict(prompt_lens=torch.tensor([4, 5])), ValueError, "prompt_lens"),
    # both int8 flags are ported: they compose with the same checks
    (dict(kv_quant_int8=True, max_new_tokens=0), ValueError, "max_new_tokens"),
    (dict(weights_int8=True, top_p=0.0), ValueError, "top_p"),
    # a mesh is ported, int8 weights on it too (tests/test_torch_tensor_parallel.py
    # and tests/test_torch_tp_serve.py decode on one): the same checks come first
    (dict(mesh=object(), max_new_tokens=0), ValueError, "max_new_tokens"),
    (dict(mesh=object(), weights_int8=True, top_k=-1), ValueError, "top_k"),
])
def test_generate_validation(kwargs, error, match):
    model = torch_gpt.GPT(torch_gpt.GPT_TINY)
    kwargs.setdefault("max_new_tokens", 2)
    with pytest.raises(error, match=match):
        torch_gpt.generate(model, torch.zeros((2, 4), dtype=torch.long), **kwargs)


def test_top_k_at_vocab_keeps_everything():
    model = torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 3), dtype=torch.long)
    wide = _sampled(model, prompt, 5, top_k=torch_gpt.GPT_TINY.vocab_size)
    assert torch.equal(wide, _sampled(model, prompt, 5))


def test_init_and_remat():
    """One seed gives one set of weights; remat (torch.utils.checkpoint)
    gives the same loss and gradients as keeping the activations."""
    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    ids = torch_gpt.synthetic_batch(torch.Generator().manual_seed(0), 2, 64, cfg)["input_ids"]
    grads = []
    for remat in (False, True):
        model = torch_gpt.GPT(
            dataclasses.replace(cfg, remat=remat), generator=torch.Generator().manual_seed(0)
        )
        torch_gpt.causal_lm_loss(model(ids), ids).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=0.0, rtol=0.0, msg=name)
    h = cfg.hidden_size
    assert abs(model.token_embed.weight.std().item() * h**0.5 - 1.0) < 0.05
    assert float(model.layer_0.attention.key.bias.detach().abs().max()) == 0.0


CLI_ARGS = ["--preset", "tiny", "--steps", "2", "--batch-size", "2", "--seq-len", "128"]


def test_cli_main_runs_on_cpu():
    before = dict(kernels.LAUNCHES)
    assert torch_gpt_cli.main(CLI_ARGS + ["--generate", "4", "--device", "cpu"]) == 0
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel


def test_cli_run_summary():
    summary = torch_gpt_cli.run(torch_gpt_cli.parse_args([
        "--preset", "tiny", "--steps", "5", "--batch-size", "4", "--seq-len", "64",
        "--learning-rate", "3e-3", "--generate", "5", "--device", "cpu",
    ]))
    assert math.isfinite(summary["loss"]) and math.isfinite(summary["eval_loss"])
    assert summary["loss"] < summary["first_loss"]
    assert summary["forward_passes"] == 6 and summary["backward_passes"] == 5
    generated = np.array(summary["generated"])
    assert generated.shape == (4, torch_gpt_cli.PROMPT_LEN + 5)
    assert summary["generate_ms_per_token"] > 0


def test_cli_wants_cuda_and_refuses_unported_flags():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_gpt_cli.main(CLI_ARGS)
    # --tp is ported, and --fsdp together with it (the 2-D mesh)
    assert torch_gpt_cli.parse_args(CLI_ARGS + ["--tp", "2"]).mesh.tp == 2
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig

    two_d = torch_gpt_cli.parse_args(CLI_ARGS + ["--tp", "2", "--fsdp", "2"]).mesh
    assert two_d == MeshConfig(dp=-1, fsdp=2, tp=2)
    # the telemetry server is ported (tests/test_torch_train_observe.py runs it)
    args = torch_gpt_cli.parse_args(CLI_ARGS + ["--monitoring-bind-addr", "127.0.0.1:0"])
    assert args.monitoring_bind_addr == "127.0.0.1:0"
    # the int8 decode flags are ported (tests/test_torch_quant.py runs them)
    args = torch_gpt_cli.parse_args(CLI_ARGS + ["--kv-int8", "--weights-int8"])
    assert args.kv_int8 and args.weights_int8
    args = torch_gpt_cli.parse_args(CLI_ARGS[:2] + ["--seq-len", "4096"])
    assert args.seq_len == 4096 and args.preset == "tiny"


@pytest.mark.cuda
def test_cuda_flash_step_matches_plain_step():
    """GPT_TINY's training step on the card, through K1-K3 and through
    plain attention in bf16, from one set of weights: the flash step
    launches each kernel once per layer, the losses agree within 2e-2,
    and every gradient is no more than 1.5x further (relative L2, floor
    1e-2) from an f32 plain step than the plain bf16 step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = torch_gpt.GPT_TINY
    batch = torch_gpt.synthetic_batch(torch.Generator().manual_seed(0), 4, 128, cfg)
    routes = (
        ("flash", None, cfg),
        ("plain", torch_gpt.plain_causal_attention, cfg),
        ("f32", torch_gpt.plain_causal_attention, dataclasses.replace(cfg, dtype=torch.float32)),
    )
    losses, grads = {}, {}
    for route, attention_fn, rcfg in routes:
        model = torch_gpt.GPT(rcfg, attention_fn, generator=torch.Generator().manual_seed(1))
        trainer = torch_trainer.Trainer(
            model, torch_trainer.causal_lm_task(), learning_rate=3e-4,
            weight_decay=0.01, device="cuda",
        )
        state = trainer.init()
        kernels.reset_launches()
        state, metrics = trainer.step(state, trainer.place_batch(batch))
        losses[route] = float(metrics["loss"])
        want = cfg.num_layers if route == "flash" else 0
        assert [kernels.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")] == [want] * 3
        grads[route] = {n: p.grad.float() for n, p in model.named_parameters()}
    assert abs(losses["flash"] - losses["plain"]) < 2e-2, losses
    for name, truth in grads["f32"].items():
        if name.endswith("attention.key.bias"):
            continue  # zero in exact arithmetic: rounding noise on every route
        norm = truth.norm().clamp_min(1e-30)
        flash = ((grads["flash"][name] - truth).norm() / norm).item()
        plain = ((grads["plain"][name] - truth).norm() / norm).item()
        assert flash <= 1.5 * max(plain, 1e-2), (name, flash, plain)
