"""The port's speculative decoding and beam search
(tf_operator_tpu_torch/models/gpt.py generate_speculative, _ngram_draft,
_accept_or_resample, beam_search; the paged verify program; serve/engine.py
speculate="ngram"|"draft") held against the JAX package's on the CPU at
GPT_TINY in f32, on the same weights (models/convert.py).

Greedy chains and verify-round counts equal the reference's; beam
sequences equal and scores within SCORE_ATOL (1e-5; the f32 differences of
two frameworks summing log-probabilities of the same logits). The sampled
path draws from a torch.Generator, another stream than jax.random's, so it
is held statistically with the reference's own tests' sample counts and
bounds (tests/test_gpt.py::TestSpeculativeSampling). The engine cases
mirror tests/test_spec_decode.py (its sharded class aside): every chain
equal to the port's inline generate and to the reference engine's, one
capture per program, the pool audit clean.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.serve import engine as jax_engine
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.serve import engine as torch_engine
from torch_threads import one_torch_thread  # noqa: F401

SCORE_ATOL = 1e-5
TCFG = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed")


class _Settled:
    """A reference program whose every call waits for its outputs.

    JAX on the CPU runs a jitted call asynchronously and takes a numpy
    argument that lies on a 64-byte boundary without a copy
    (test_reference_host_arguments_alias_calls_in_flight). The reference
    engine rewrites its host arrays (_tok, _index, _prompt, _lens,
    _tables, _d_tok, _d_index) at the next admission, while programs it
    did not wait for may still read them; whether they do depends on
    where the allocator put the arrays, so its counters moved from run to
    run. Waiting here gives every call the arrays as they were when it
    was made."""

    PROGRAMS = ("prefill", "copy_block", "verify")

    def __init__(self, fn):
        self._fn = fn

    def __getattr__(self, name):
        attr = getattr(self._fn, name)
        return _Settled(attr) if name in self.PROGRAMS else attr

    def __call__(self, *args, **kwargs):
        return jax.block_until_ready(self._fn(*args, **kwargs))


def reference_engine(*args, **kwargs):
    """The reference's ContinuousBatchingEngine, its warm-ups at
    construction waited for and every later program call settled."""
    eng = jax_engine.ContinuousBatchingEngine(*args, **kwargs)
    jax.block_until_ready((eng._cache, getattr(eng, "_d_cache", None)))
    eng.step = _Settled(eng.step)
    if eng.draft is not None:
        eng.draft = _Settled(eng.draft)
    return eng


def _flax(cfg, seed):
    jcfg = dataclasses.replace(cfg, dtype=jnp.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jcfg, jax.tree_util.tree_map(np.array, params["params"])


def _port(tcfg, params):
    model = torch_gpt.GPT(tcfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def weights():
    """(reference f32 cfg, flax params, port f32 model) on one set of
    weights."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg, params = _flax(jax_gpt.GPT_TINY, 0)
    return jcfg, params, _port(TCFG, params)


@pytest.fixture(scope="module")
def draft(weights):
    """(reference GPT_DRAFT cfg, its flax params, the port's draft model)."""
    jcfg, params = _flax(jax_gpt.GPT_DRAFT, 1)
    return jcfg, params, _port(dataclasses.replace(torch_gpt.GPT_DRAFT, dtype=torch.float32),
                               params)


# -- the drafter ----------------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("rows, index, k, ngram", [
    ([[1, 2, 3, 1, 2, 7, 7, 1, 2, 0, 0, 0]], 8, 3, 2),        # two earlier hits: latest
    ([[5, 6, 5, 6, 5, 6, 0, 0, 0, 0]], 5, 4, 2),              # continuation reads stale
    ([[4, 4, 4, 4, 4, 0, 0, 0]], 4, 2, 1),                    # ngram 1
    ([[1, 2, 3, 4, 5, 6, 0, 0]], 5, 2, 2),                    # no match: repeat current
    ([[9, 8, 7, 9, 8, 7, 9, 8, 0, 0], [1, 1, 2, 1, 1, 2, 1, 1, 3, 3]], 7, 3, 3),
    ([[3, 3, 3, 3, 3, 3, 3, 3, 3, 3]], 9, 4, 2),              # start clips to L - k
])
def test_ngram_draft_matches_reference(rows, index, k, ngram):
    buf = np.asarray(rows, np.int32)
    want = np.asarray(jax_gpt._ngram_draft(jnp.asarray(buf), jnp.int32(index), k, ngram))
    got = torch_gpt._ngram_draft(torch.tensor(buf).long(), index, k, ngram).numpy()
    np.testing.assert_array_equal(got, want)


# -- generate_speculative --------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(12)
    repeated = np.tile(np.arange(17, 26), 3)[None, :24]
    return {"repeated": repeated.astype(np.int32),
            "random": rng.integers(0, 512, (1, 20)).astype(np.int32),
            "batch": rng.integers(0, 512, (3, 10)).astype(np.int32)}


@pytest.mark.parametrize("kind", ["repeated", "random", "batch"])
def test_speculative_greedy_equals_generate_and_reference(weights, kind):
    """Greedy generate_speculative: the chain equal to the port's
    generate and to the reference's generate_speculative, with the same
    number of verify rounds; the rounds within [ceil((new - 1) / (k +
    1)), new - 1] (every round commits one to k + 1 tokens)."""
    jcfg, params, model = weights
    prompt = _prompts()[kind]
    new, k = 40, 4
    got, rounds = torch_gpt.generate_speculative(model, torch.tensor(prompt), new, draft_k=k,
                                                 return_rounds=True)
    assert torch.equal(got, torch_gpt.generate(model, torch.tensor(prompt), new))
    want, want_rounds = jax_gpt.generate_speculative(jcfg, params, jnp.asarray(prompt), new,
                                                     draft_k=k, return_rounds=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == want_rounds
    assert -(-(new - 1) // (k + 1)) <= rounds <= new - 1
    if kind == "repeated":
        assert rounds < new - 1  # the lookup paid off


def test_speculative_int8_and_near_max_length(weights):
    """Both int8 flags compose (the chain equal to generate's with them),
    and a decode that ends at max_seq_len (the verify overshoot past
    `total` lands in the cache's draft_k-wide tail) equals generate."""
    _, _, model = weights
    prompt = torch.tensor(_prompts()["repeated"])
    got = torch_gpt.generate_speculative(model, prompt, 30, kv_quant_int8=True,
                                         weights_int8=True)
    assert torch.equal(got, torch_gpt.generate(model, prompt, 30, kv_quant_int8=True,
                                               weights_int8=True))
    long = torch.tensor(np.tile(np.arange(40, 48), 13)[None, :100])
    new = TCFG.max_seq_len - 100
    assert torch.equal(torch_gpt.generate_speculative(model, long, new),
                       torch_gpt.generate(model, long, new))


@pytest.mark.parametrize("kwargs, match", [
    (dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
    (dict(max_new_tokens=200), "exceeds max_seq_len"),
    (dict(draft_k=0), "draft_k must be >= 1"),
    (dict(ngram=0), "ngram must be >= 1"),
    (dict(ngram=5), "prompt_len 4 must be >= ngram 5"),
    (dict(temperature=-1.0), "temperature must be >= 0"),
    (dict(top_k=-1), "top_k must be >= 0"),
    (dict(top_p=0.0), r"top_p must be in \(0, 1\]"),
])
def test_speculative_validation(kwargs, match):
    model = torch_gpt.GPT(torch_gpt.GPT_TINY)
    kwargs.setdefault("max_new_tokens", 2)
    with pytest.raises(ValueError, match=match):
        torch_gpt.generate_speculative(model, torch.zeros((1, 4), dtype=torch.long), **kwargs)


# -- speculative sampling (tests/test_gpt.py::TestSpeculativeSampling) ----------


def test_acceptance_lemma():
    """Accept draft d with probability p[d], else resample from p with d
    zeroed: the output is distributed as p. A dense grid of 512 uniform
    draws x 16 seeds (V = 8, d = 3), the reference's counts and bound."""
    vocab, grid, keys = 8, 512, 16
    p = torch.softmax(torch.randn(vocab, generator=torch.Generator().manual_seed(0)) * 1.5, 0)
    us = (torch.arange(grid, dtype=torch.float32) + 0.5) / grid
    counts = np.zeros(vocab)
    for key in range(keys):
        gen = torch.Generator().manual_seed(7 + key)
        toks = torch_gpt._accept_or_resample(
            p[None].expand(grid, vocab), torch.full((grid,), 3), us, gen)
        counts += np.bincount(toks.numpy(), minlength=vocab)
    np.testing.assert_allclose(counts / counts.sum(), p.numpy(), atol=0.02)


def test_bonus_round_samples_target_directly():
    """d = -1 (no draft, the bonus token) samples p itself."""
    vocab = 6
    p = torch.softmax(torch.randn(vocab, generator=torch.Generator().manual_seed(3)), 0)
    toks = torch_gpt._accept_or_resample(p[None].expand(4096, vocab),
                                         torch.full((4096,), -1), torch.ones(4096),
                                         torch.Generator().manual_seed(0))
    freq = np.bincount(toks.numpy(), minlength=vocab) / 4096
    np.testing.assert_allclose(freq, p.numpy(), atol=0.03)


def _repetitive_prompt():
    base = torch.randint(0, TCFG.vocab_size, (1, 4), generator=torch.Generator().manual_seed(1))
    return base.repeat(1, 2)  # len 8, repetitive


def _filtered_true(model, ids):
    logits = model(ids)[0, -1].float()
    return torch.softmax(torch_gpt._filter_logits(logits[None], 8, 1.0)[0], 0).detach().numpy()


def test_sampled_spec_marginal_matches_model_distribution():
    """The first sampled token's marginal over 400 seeds against the
    model's top-8 filtered distribution (the reference's atol 0.07)."""
    model = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(0))
    prompt = _repetitive_prompt()
    p_true = _filtered_true(model, prompt)
    counts = np.zeros(TCFG.vocab_size)
    for seed in range(400):
        out = torch_gpt.generate_speculative(model, prompt, 4, temperature=1.0, top_k=8,
                                             generator=torch.Generator().manual_seed(seed))
        counts[int(out[0, 8])] += 1
    np.testing.assert_allclose(counts / 400, p_true, atol=0.07)


def test_second_token_conditional_through_the_loop():
    """The second token goes through a draft -> accept/resample round:
    over 600 seeds, the seeds whose first token is the modal one give a
    second-token marginal within the reference's atol 0.14 of the model's
    filtered distribution after that prefix."""
    model = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(0))
    prompt = _repetitive_prompt()
    firsts, seconds = np.zeros(600, np.int64), np.zeros(600, np.int64)
    for seed in range(600):
        out = torch_gpt.generate_speculative(model, prompt, 2, temperature=1.0, top_k=8,
                                             generator=torch.Generator().manual_seed(seed))
        firsts[seed], seconds[seed] = int(out[0, 8]), int(out[0, 9])
    modal = np.bincount(firsts).argmax()
    cond = seconds[firsts == modal]
    assert len(cond) >= 60, len(cond)
    p_true = _filtered_true(model, torch.cat([prompt, torch.tensor([[int(modal)]])], dim=1))
    freq = np.bincount(cond, minlength=TCFG.vocab_size) / len(cond)
    np.testing.assert_allclose(freq, p_true, atol=0.14)


# -- beam search -------------------------------------------------------------


def _teacher_forced_scores(model, seqs, prompt_len):
    """Sum of the generated tokens' log-probabilities under the training
    forward, per beam."""
    b, beams, total = seqs.shape
    flat = seqs.reshape(b * beams, total)
    logp = torch.log_softmax(model(flat).float(), dim=-1)
    picked = logp[:, prompt_len - 1:-1].gather(2, flat[:, prompt_len:, None])[..., 0]
    return picked.sum(dim=1).reshape(b, beams)


@pytest.mark.parametrize("kv, w", [(False, False), (True, True)], ids=["f32", "int8"])
def test_beam_search_matches_reference(weights, kv, w):
    """beam_search against the reference's on the same weights (its
    quantized tree under weights_int8): sequences equal, scores within
    SCORE_ATOL, best first; at f32 each score equals the teacher-forced
    sum of the beam's log-probabilities within SCORE_ATOL."""
    jcfg, params, model = weights
    prompt = np.random.default_rng(8).integers(0, 512, (2, 6)).astype(np.int32)
    tree = params
    if w:
        from tf_operator_tpu.ops.quant import quantize_params

        tree = quantize_params(params)
    want_seqs, want_scores = jax_gpt.beam_search(jcfg, tree, jnp.asarray(prompt), 10,
                                                 num_beams=4, kv_quant_int8=kv,
                                                 weights_int8=w)
    seqs, scores = torch_gpt.beam_search(model, torch.tensor(prompt), 10, num_beams=4,
                                         kv_quant_int8=kv, weights_int8=w)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=SCORE_ATOL)
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())
    if not kv:
        np.testing.assert_allclose(_teacher_forced_scores(model, seqs, 6).detach().numpy(),
                                   scores.numpy(), atol=SCORE_ATOL)


def test_beam_one_is_greedy_and_validation(weights):
    """num_beams=1 reduces to greedy generate; the reference's
    ValueErrors; beams wider than the first step's distinct tokens keep
    the lower index on ties (jax.lax.top_k's order)."""
    _, _, model = weights
    prompt = torch.tensor(np.random.default_rng(9).integers(0, 512, (3, 5)))
    seqs, scores = torch_gpt.beam_search(model, prompt, 12, num_beams=1)
    assert torch.equal(seqs[:, 0], torch_gpt.generate(model, prompt, 12))
    assert scores.shape == (3, 1)
    for kwargs, match in ((dict(num_beams=0), "num_beams must be >= 1"),
                          (dict(num_beams=513), "num_beams 513 exceeds vocab 512"),
                          (dict(max_new_tokens=0), "max_new_tokens must be >= 1")):
        kwargs.setdefault("max_new_tokens", 2)
        with pytest.raises(ValueError, match=match):
            torch_gpt.beam_search(model, prompt, **kwargs)
    ties = torch.tensor([[0.0, 1.0, 1.0, 0.5, 1.0]])
    values, order = torch_gpt._top_k(ties, 3)
    assert order.tolist() == [[1, 2, 4]] and values.tolist() == [[1.0, 1.0, 1.0]]


# -- the engine's verify rounds (tests/test_spec_decode.py) ---------------------


def drive(engine, handles, cancel_at=None, max_iters=5000, trajectory=None):
    """The scheduler loop, by hand: admit, evict, one quantum."""
    cancel_at = cancel_at or {}
    for it in range(max_iters):
        for i in cancel_at.get(it, ()):
            handles[i].cancel()
        if all(h.done.is_set() for h in handles):
            return
        engine._admit()
        engine._evict_cancelled()
        if engine.active_slots:
            engine._work_once()
            if trajectory is not None:
                trajectory.append(int(engine._slot_depth[0]))
    raise AssertionError("drive() did not converge")


def results(handles):
    out = []
    for h in handles:
        try:
            out.append(h.result(1))
        except (torch_engine.DecodeCancelled, jax_engine.DecodeCancelled):
            out.append(None)
    return out


def inline(model, row, new):
    return torch_gpt.generate(model, torch.tensor([row]), new)[0].tolist()


def _soak_jobs():
    rng = np.random.default_rng(23)
    system = rng.integers(0, 512, size=16).tolist()
    jobs = [(system, 4), (system, 4), (system + [9, 9], 4)]
    jobs.append((rng.integers(0, 512, size=TCFG.max_seq_len - 6).tolist(), 4))
    jobs.append(([5, 6, 7] * 8, 10))  # repetitive: the lookup hits
    for _ in range(6):
        new = int(rng.integers(1, 6))
        jobs.append((rng.integers(0, 512, size=int(rng.integers(1, 36))).tolist(), new))
    return jobs


def test_ngram_engine_soak_matches_reference_and_inline(weights):
    """speculate="ngram" on a shared-prefix family (prefix cache and
    copy-on-write), a near-max prompt, a repetitive row, random fill and
    two mid-flight cancels: outcomes equal the reference engine's and
    every chain the inline generate's; the round, proposal and accept
    counters equal the reference's; one capture per program; the pool
    audit clean and empty; the spec metric families present."""
    jcfg, params, model = weights
    jobs = _soak_jobs()
    kw = dict(n_slots=3, block_size=8, prefill_chunk=8, speculate="ngram", spec_depth=4)
    ref = reference_engine(jcfg, params, start=False, **kw)
    port = torch_engine.ContinuousBatchingEngine(model, start=False, device="cpu", **kw)
    outs = []
    for eng in (ref, port):
        head = eng.submit(*jobs[0])
        drive(eng, [head])
        handles = [head] + [eng.submit(row, new) for row, new in jobs[1:]]
        drive(eng, handles, cancel_at={2: [6], 7: [9]})
        outs.append(results(handles))
    assert outs[1] == outs[0]
    assert (port.spec_rounds, port.spec_proposed, port.spec_accepted) == \
        (ref.spec_rounds, ref.spec_proposed, ref.spec_accepted)
    for (row, new), got in zip(jobs, outs[1]):
        if got is not None:
            assert got == inline(model, row, new), (len(row), new)
    port.stop()
    assert (port.step.compiles, port.step.prefill_compiles, port.step.verify_compiles) == (1, 1, 1)
    assert port.spec_accepted > 0 and port.pool.hits > 0
    port.pool.check()
    assert port.pool.in_use() == 0
    flat = {name: val for (name, _), val in port.metrics().items()}
    assert flat["spec_rounds_total"] == port.spec_rounds
    assert flat["engine_verify_compiles_total"] == 1
    assert 0.0 <= flat["spec_accept_rate"] <= 1.0


@needs_jax
def test_reference_host_arguments_alias_calls_in_flight():
    """Why reference_engine settles the reference's programs: on the CPU
    a jitted call queued behind a slow one returns at once, and a numpy
    argument that starts on a 64-byte boundary is taken without a copy,
    so the call reads a host write made after it returned. An argument
    off that boundary is copied when the call is made."""

    @jax.jit
    def slow(big):
        y = big
        for _ in range(8):
            y = jnp.tanh(y @ big)
        return y.sum()

    @jax.jit
    def add(gate, x):
        return x + (0.0 * gate).astype(jnp.int32)

    big = jnp.asarray(np.random.default_rng(0).random((800, 800), np.float32))
    add(slow(big), np.ones(64, np.int32)).block_until_ready()  # both compiled
    raw = np.zeros(64 + 2 * 256, np.uint8)
    start = (-raw.ctypes.data) % 64
    seen = {}
    for offset in (0, 4):
        x = raw[start + offset:start + offset + 256].view(np.int32)
        x[:] = 1
        out = add(slow(big), x)
        x[:] = 5
        seen[offset] = int(np.asarray(out)[0])
    assert seen == {0: 5, 4: 1}


def test_off_ngram_and_draft_engines_emit_identical_chains(weights, draft):
    """The same jobs through speculate off, ngram and draft (GPT_DRAFT
    on its converted weights, beside the reference's draft engine):
    equal chains; the draft's step captured once; the draft engine's
    counters equal the reference's."""
    jcfg, params, model = weights
    djcfg, dparams, dmodel = draft
    jobs = [([3, 1, 4, 1, 5, 9, 2, 6], 8), ([2, 7] * 6, 12), (list(range(40, 70)), 6)]
    chains = {}
    for speculate in ("off", "ngram", "draft"):
        eng = torch_engine.ContinuousBatchingEngine(
            model, n_slots=2, start=False, block_size=8, prefill_chunk=6, device="cpu",
            speculate=speculate, spec_depth=3, draft_model=dmodel,
        )
        handles = [eng.submit(row, new) for row, new in jobs]
        drive(eng, handles)
        chains[speculate] = results(handles)
        eng.stop()
        eng.pool.check()
        assert eng.pool.in_use() == 0
        if speculate == "draft":
            assert eng.draft.compiles == 1 and eng.spec_rounds > 0
            port_counts = (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted)
    assert chains["ngram"] == chains["off"] == chains["draft"]
    ref = reference_engine(
        jcfg, params, n_slots=2, start=False, block_size=8, prefill_chunk=6,
        speculate="draft", spec_depth=3, draft_cfg=djcfg, draft_params=dparams)
    handles = [ref.submit(row, new) for row, new in jobs]
    drive(ref, handles)
    assert results(handles) == chains["draft"]
    assert (ref.spec_rounds, ref.spec_proposed, ref.spec_accepted) == port_counts


def test_draft_rows_past_max_total_stay_in_the_cache(weights, draft):
    """Draft mode with a request ending at max_total (prompt 126 + 2 new)
    beside a fresh slot whose prompt rides the forcing rule at depth 3:
    the first row, at depth 0 one token from its end, steps on with the
    draft grid past the cache's last position. The draft sees positions
    clamped to the cache; both chains equal the reference engine's (whose
    dynamic_update_slice clamps) and the inline generate's."""
    jcfg, params, model = weights
    djcfg, dparams, dmodel = draft
    near = [(i * 11) % 512 for i in range(126)]
    fresh = [(i * 5 + 3) % 512 for i in range(16)]
    kw = dict(n_slots=2, start=False, block_size=8, prefill_chunk=16, speculate="draft",
              spec_depth=3)
    ref = reference_engine(jcfg, params, draft_cfg=djcfg,
                                              draft_params=dparams, **kw)
    port = torch_engine.ContinuousBatchingEngine(model, device="cpu", draft_model=dmodel, **kw)
    step = port.draft
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(step, name)

        def __call__(self, tok, index, prompt, lens):
            seen.append((int(port._d_index.max()), int(np.max(index))))
            return step(tok, index, prompt, lens)

    port.draft = Recorder()
    outs = []
    for eng in (ref, port):
        head = eng.submit(near, 2)
        while int(eng._index[0]) < 120:  # the near-max row's prefill, then forcing
            eng._admit()
            eng._work_once()
        handles = [head, eng.submit(fresh, 20)]
        drive(eng, handles)
        outs.append(results(handles))
    assert max(raw for raw, _ in seen) >= port.max_total  # the overshoot happened
    assert max(clamped for _, clamped in seen) == port.max_total - 1
    assert outs[1] == outs[0]
    assert outs[1] == [inline(model, near, 2), inline(model, fresh, 20)]
    assert (port.spec_rounds, port.spec_proposed, port.spec_accepted) == \
        (ref.spec_rounds, ref.spec_proposed, ref.spec_accepted)
    port.stop()
    port.pool.check()
    assert port.pool.in_use() == 0


def _clamping_attention(kv, index, tables):
    """A planted fault: _paged_verify_attention with positions past the
    table clamped into its last entry instead of sent to the sentinel."""
    def attend(query, key, value, mask):
        slots, k1 = key.shape[:2]
        bs = kv[0].shape[1]
        pos = index[:, None] + torch.arange(k1)[None, :]
        phys = tables.gather(1, (pos // bs).clamp(max=tables.shape[1] - 1))
        flat = slots * k1
        return torch_gpt._paged_kv(kv, key.reshape(flat, *key.shape[2:]),
                                   value.reshape(flat, *value.shape[2:]), phys.reshape(flat),
                                   (pos % bs).reshape(flat), query, tables, mask)
    return attend


def test_near_max_overshoot_goes_to_the_sentinel(weights, monkeypatch):
    """A prompt 3 short of max_total: the verify windows reach past the
    table, and those positions must land on the sentinel block; the chain
    equals the inline generate's. The planted control, a verify that
    clamps them into the table's last entry (a real block holding
    committed keys and values), corrupts that chain."""
    _, _, model = weights
    row = [(i * 11) % 512 for i in range(TCFG.max_seq_len - 3)]
    want = inline(model, row, 3)

    def serve():
        eng = torch_engine.ContinuousBatchingEngine(
            model, n_slots=2, start=False, block_size=8, prefill_chunk=16, device="cpu",
            speculate="ngram", spec_depth=4)
        h = eng.submit(row, 3)
        drive(eng, [h])
        eng.stop()
        eng.pool.check()
        assert eng.pool.in_use() == 0
        return h.result(1)

    assert serve() == want
    monkeypatch.setattr(torch_gpt, "_paged_verify_attention", _clamping_attention)
    assert serve() != want


def test_depth_collapse_probe_and_recovery(weights):
    """The adaptive depth on an incompressible prompt: it walks down to
    0, sits out on the plain step, and probes back in at depth 1, the
    same trajectory and counters on two runs and the same trajectory as
    the reference engine's; the chain is the inline one. Then the grow
    branch: a prefix hit leaves a long prompt tail to the forcing rule,
    where acceptance is 1.0, so a knocked-down depth climbs back to the
    cap."""
    jcfg, params, model = weights
    row = np.random.default_rng(31).integers(0, 512, size=12).tolist()
    runs = []
    for make in ("port", "port", "ref"):
        if make == "ref":
            eng = reference_engine(
                jcfg, params, n_slots=2, start=False, block_size=8, speculate="ngram",
                spec_depth=4)
        else:
            eng = torch_engine.ContinuousBatchingEngine(
                model, n_slots=2, start=False, block_size=8, device="cpu", speculate="ngram",
                spec_depth=4)
        h = eng.submit(row, 90)
        trajectory = []
        drive(eng, [h], trajectory=trajectory)
        runs.append((trajectory, (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted,
                                  eng.spec_fallback_steps), h.result(1)))
    assert runs[0] == runs[1] == runs[2]
    traj, counters, got = runs[0]
    assert got == inline(model, row, 90)
    assert 0 in traj and counters[3] >= torch_engine._SPEC_PROBE_ROUNDS - 1
    assert 1 in traj[traj.index(0):]
    eng = torch_engine.ContinuousBatchingEngine(
        model, n_slots=2, start=False, block_size=8, prefill_chunk=0, device="cpu",
        speculate="ngram", spec_depth=4)
    system = [7 * (i % 5) + 1 for i in range(16)]
    drive(eng, [eng.submit(system, 4)])
    tail = [(i * 13) % 512 for i in range(88)]
    h = eng.submit(system + tail, 4)
    eng._admit()
    assert eng.pool.hits > 0
    eng._slot_depth[:] = 1
    for hist in eng._accept_hist:
        hist.clear()
    drive(eng, [h])
    assert int(eng._slot_depth.max()) == eng.spec_depth
    assert h.result(1) == inline(model, system + tail, 4)
    eng.stop()
    eng.pool.check()


@pytest.mark.parametrize("kwargs, match", [
    (dict(kv_layout="dense", speculate="ngram"), "requires kv_layout='paged'"),
    (dict(speculate="medusa"), "speculate must be 'off', 'ngram' or 'draft'"),
    (dict(speculate="ngram", spec_depth=0), "spec_depth must be >= 1"),
    (dict(speculate="draft"), "needs draft_model"),
])
def test_engine_spec_validation(kwargs, match):
    model = torch_gpt.GPT(torch_gpt.GPT_TINY)
    with pytest.raises(ValueError, match=match):
        torch_engine.ContinuousBatchingEngine(model, n_slots=2, start=False, block_size=8,
                                              device="cpu", **kwargs)


def test_draft_vocab_and_length_are_refused_in_the_reference_words():
    """A draft with another vocabulary (GPT_DRAFT against a 32000-token
    target) and one shorter than max_total are refused."""
    small_vocab = dataclasses.replace(torch_gpt.GPT_TINY, vocab_size=1000)
    target = torch_gpt.GPT(small_vocab)
    with pytest.raises(ValueError, match=r"draft vocab 512 != target vocab 1000 \(the draft "
                                         r"must share the tokenizer\)"):
        torch_engine.ContinuousBatchingEngine(
            target, n_slots=2, start=False, block_size=8, device="cpu", speculate="draft",
            draft_model=torch_gpt.GPT(torch_gpt.GPT_DRAFT))
    short = torch_gpt.GPT(dataclasses.replace(torch_gpt.GPT_DRAFT, max_seq_len=64))
    with pytest.raises(ValueError, match="draft max_seq_len 64 < engine max_total 128"):
        torch_engine.ContinuousBatchingEngine(
            torch_gpt.GPT(torch_gpt.GPT_TINY), n_slots=2, start=False, block_size=8,
            device="cpu", speculate="draft", draft_model=short)


def test_paged_verify_matches_reference_program(weights):
    """The verify program alone against the reference's on one grid:
    slots mid-prompt, mid-decode and idle, a window crossing a block
    edge: next tokens equal, and the logits its rows expose equal the
    single-token step's at row 0 (the same computation)."""
    jcfg, params, model = weights
    n, total, bs, nb, k = 3, 32, 8, 13, 3
    rng = np.random.default_rng(4)
    prompt = np.zeros((n, total), np.int32)
    lens = np.array([12, 5, 1], np.int32)
    for i, length in enumerate(lens):
        prompt[i, :length] = rng.integers(0, 512, length)
    tables = rng.permutation(np.arange(1, nb))[:n * 4].reshape(n, 4).astype(np.int32)
    jstep = jax_gpt.PagedSlotDecodeStep(jcfg, n, total, bs, nb, spec_depth=k)
    jcache = jstep.init_cache()
    step = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb, spec_depth=k)
    toks = rng.integers(0, 512, (n, k + 1)).astype(np.int32)
    index = np.array([6, 7, 0], np.int32)
    jcache, want = jstep.verify(params, jcache, toks, index, prompt, lens, tables)
    got = step.verify(toks, index, prompt, lens, tables)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert step.verify_compiles == 1
    single = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
    single.cache = step.cache.map(torch.clone)
    single(toks[:, 0], index, prompt, lens, tables)
    np.testing.assert_allclose(step.verify_logits[:, 0].numpy(), single.logits.numpy(),
                               atol=1e-5)
    with pytest.raises(RuntimeError, match="spec_depth > 0"):
        single.verify(toks, index, prompt, lens, tables)
