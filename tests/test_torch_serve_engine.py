"""The port's continuous-batching engine
(tf_operator_tpu_torch/serve/engine.py) held against the JAX package's
(tf_operator_tpu/serve/engine.py) on the CPU, in f32, on the same weights
(the flax params carried across with models/convert.py).

Both engines are built with start=False and driven by hand with one
schedule (`drive`, as tests/test_engine.py's TestPagedEngine.drive), so
they admit, chunk, copy, cancel and evict at the same quanta, on the
seeded mixes of tests/test_engine.py: paged and dense layouts, prefix
sharing with copy-on-write, chunked prefill, cancels mid-decode and
mid-prefill, pool exhaustion (FIFO), over-pool rejection and a device
error's fan-out and recovery. Every finished chain must be token-equal to
the reference engine's, to the port's dense engine's and to the port's
inline generate; each decision of each chain is first checked to have a
top-2 logit margin above MIN_MARGIN (teacher-forced through the port's
GPTDecodeStep), far above the ~1e-6 f32 differences between the two
frameworks, so that a near-tie cannot make a comparison flaky. On the
CPU the programs run eagerly; `compiles` counts their first calls.
"""

import dataclasses
import threading

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

# the smallest top-2 logit gap a chain test accepts at a decision
MIN_MARGIN = 1e-4


def _configs():
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, flax params, port model) on one set of weights."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg, tcfg = _configs()
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    model = torch_gpt.GPT(tcfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return jcfg, params, model


def engines(weights, **kw):
    """(reference engine, port engine), both start=False, one config."""
    jcfg, params, model = weights
    ref = jax_engine.ContinuousBatchingEngine(jcfg, params, start=False, **kw)
    port = torch_engine.ContinuousBatchingEngine(model, start=False, device="cpu", **kw)
    return ref, port


def drive(engine, handles, cancel_at=None, max_iters=5000):
    """The scheduler loop, by hand: admit, evict, one quantum.
    cancel_at: {iteration: [handle index, ...]} fired between quanta."""
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
    raise AssertionError("drive() did not converge")


def outcomes(handles):
    """Each handle's chain, "cancelled", or its error's type name."""
    out = []
    for h in handles:
        try:
            out.append(h.result(1))
        except (torch_engine.DecodeCancelled, jax_engine.DecodeCancelled):
            out.append("cancelled")
        except Exception as err:  # noqa: BLE001 — compared by name
            out.append(type(err).__name__)
    return out


def inline(model, row, new):
    return torch_gpt.generate(model, torch.tensor([row]), new)[0].tolist()


def min_margin(model, chain, prompt_len):
    """The smallest top-2 logit gap of GPTDecodeStep along `chain` at its
    decisions (positions prompt_len - 1 .. len - 2)."""
    n = len(chain)
    cache = torch_gpt.KVCache.zeros(model.cfg, 1, n)
    step = torch_gpt.GPTDecodeStep(model)
    gaps = []
    for i in range(n - 1):
        logits = step(torch.tensor([chain[i]]), i, cache)
        if i >= prompt_len - 1:
            top2 = torch.topk(logits[0], 2).values
            gaps.append(float(top2[0] - top2[1]))
    return min(gaps)


def hold(weights, jobs, ref_out, port_out):
    """Port outcomes equal the reference's; each finished chain has every
    decision's margin above MIN_MARGIN and equals the inline generate."""
    model = weights[2]
    assert port_out == ref_out
    for (row, new), got in zip(jobs, port_out):
        if isinstance(got, list):
            assert min_margin(model, got, len(row)) > MIN_MARGIN
            assert got == inline(model, row, new)


def run_mix(weights, jobs, cancel_at=None, **kw):
    ref, port = engines(weights, **kw)
    outs = []
    for engine in (ref, port):
        handles = [engine.submit(row, new) for row, new in jobs]
        drive(engine, handles, cancel_at)
        outs.append(outcomes(handles))
    return ref, port, outs[0], outs[1]


def test_paged_soak_matches_reference_and_dense(weights):
    """tests/test_engine.py's soak: a seeded mix of lengths, budgets, a
    shared 16-token prefix and three mid-flight cancels, under a pool small
    enough to force head-of-line waits and LRU reclaim, with 5-token
    prefill chunks. Port == reference, chain for chain; the survivors
    through the port's dense grid give the same chains; one capture per
    program; the pool ends with nothing leaked."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, 512, size=16).tolist()
    jobs = []
    for _ in range(20):
        new = int(rng.integers(1, 6))
        row = rng.integers(0, 512, size=int(rng.integers(1, 36))).tolist()
        if rng.random() < 0.5:
            row = (system + row)[:128 - new]
        jobs.append((row, new))
    ref, port, ref_out, port_out = run_mix(
        weights, jobs, cancel_at={3: [4], 9: [11], 15: [17]}, n_slots=3,
        kv_layout="paged", block_size=8, kv_blocks=22, prefill_chunk=5,
    )
    hold(weights, jobs, ref_out, port_out)
    assert port_out.count("cancelled") == 3
    for name in ("hits", "misses", "hit_tokens", "cow_copies", "reclaimed"):
        assert getattr(port.pool, name) == getattr(ref.pool, name), name
    assert port.pool.hits > 0
    assert (port.steps, port.prefill_chunks) == (ref.steps, ref.prefill_chunks)
    assert (port.step.compiles, port.step.prefill_compiles) == (1, 1)
    for engine in (ref, port):
        engine.stop()
    port.pool.check()
    assert port.pool.in_use() == 0
    survivors = [(job, got) for job, got in zip(jobs, port_out) if isinstance(got, list)]
    dense = torch_engine.ContinuousBatchingEngine(
        weights[2], n_slots=3, start=False, kv_layout="dense", device="cpu",
    )
    handles = [dense.submit(row, new) for (row, new), _ in survivors]
    drive(dense, handles)
    assert outcomes(handles) == [got for _, got in survivors]
    assert dense.step.compiles == 1
    dense.stop()


def test_prefix_cache_shares_and_copies_on_write(weights):
    """A decoded prompt's full blocks are shared at first emit: an
    identical re-submission reuses all of them (one copy-on-write for the
    tail), a same-prefix one the full-block prefix; counters as the
    reference's."""
    system = [7 * (i % 5) + 1 for i in range(16)]  # 2 full blocks
    ref, port = engines(weights, n_slots=2, kv_layout="paged", block_size=8, prefill_chunk=0)
    jobs = [(system, 4), (system, 4), (system + [9, 9], 4)]
    outs = []
    for engine in (ref, port):
        first = engine.submit(*jobs[0])
        drive(engine, [first])
        assert engine.pool.cached_blocks() == 2
        rest = [engine.submit(row, new) for row, new in jobs[1:]]
        drive(engine, rest)
        outs.append(outcomes([first] + rest))
        assert (engine.pool.cow_copies, engine.pool.hits) == (1, 4)
        engine.stop()
        engine.pool.check()
        assert engine.pool.in_use() == 0
    hold(weights, jobs, *outs)
    assert outs[1][1] == outs[1][0]
    assert port.step.copy_compiles == 1


def test_chunked_prefill_does_not_stall_and_matches(weights):
    """While a 120-token prompt ingests 8 tokens a quantum, an already
    decoding stream emits a token every quantum; 14 chunks, as the
    reference."""
    long_row = [int(t) for t in np.arange(120) % 511]
    jobs = [([3, 1], 40), (long_row, 4)]
    ref, port = engines(weights, n_slots=2, kv_layout="paged", block_size=8, prefill_chunk=8)
    outs = []
    for engine in (ref, port):
        short = engine.submit(*jobs[0])
        engine._admit()
        engine._work_once()
        engine._work_once()
        emitted = len(short.tokens)
        assert emitted > 0
        long = engine.submit(*jobs[1])
        engine._admit()
        assert 1 in engine._prefilling
        stalls = 0
        while 1 in engine._prefilling:
            engine._work_once()
            stalls += len(short.tokens) == emitted
            emitted = len(short.tokens)
        assert stalls == 0
        assert engine.prefill_chunks == 14
        drive(engine, [short, long])
        outs.append(outcomes([short, long]))
        engine.stop()
        engine.pool.check()
    hold(weights, jobs, *outs)


def test_cancel_mid_prefill_releases_blocks(weights):
    for engine in engines(weights, n_slots=2, kv_layout="paged", block_size=8, prefill_chunk=8):
        req = engine.submit(list(range(100)), 4)
        engine._admit()
        engine._work_once()  # one chunk in, still prefilling
        assert engine._prefilling and engine.pool.in_use() > 0
        req.cancel()
        engine._evict_cancelled()
        assert outcomes([req]) == ["cancelled"]
        assert not engine._prefilling and engine.pool.in_use() == 0
        engine.pool.check()
        engine.stop()


def test_pool_exhaustion_queues_fifo(weights):
    """Each request needs 3 of the pool's 8 blocks: at most two run at
    once despite 4 slots, the head waits, nobody overtakes."""
    jobs = [(list(range(i, i + 16)), 8) for i in range(4)]
    ref, port, ref_out, port_out = run_mix(
        weights, jobs, n_slots=4, kv_layout="paged", block_size=8, kv_blocks=8,
        prefill_chunk=0, prefix_cache=False,
    )
    hold(weights, jobs, ref_out, port_out)
    for engine in (ref, port):
        assert engine.peak_active <= 2 and engine.finished == 4
        engine.stop()
        engine.pool.check()


def test_over_pool_prompt_rejected_at_submit(weights):
    for engine in engines(weights, n_slots=2, kv_layout="paged", block_size=8, kv_blocks=4):
        with pytest.raises(ValueError, match="KV blocks"):
            engine.submit(list(range(40)), 8)  # needs 6 of 4 blocks
        engine.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_device_error_fans_out_and_engine_recovers(weights, layout):
    """A failed step fails every in-flight request with its error, the
    pool ends empty with the prefix cache dropped (paged), and the next
    request decodes as before: on both engines alike."""
    kw = dict(n_slots=2, kv_layout=layout)
    if layout == "paged":
        kw.update(block_size=8, prefill_chunk=0)
    ref, port = engines(weights, **kw)
    outs = []
    for engine in (ref, port):
        warm = engine.submit(list(range(16)), 4)
        drive(engine, [warm])
        real = engine.step

        class Boom:
            """The real step, but its next call raises."""

            armed = True

            def __getattr__(self, name):
                return getattr(real, name)

            def __call__(self, *args):
                if self.armed:
                    self.armed = False
                    raise RuntimeError("injected device failure")
                return real(*args)

        engine.step = Boom()
        failed = [engine.submit([1, 2, 3], 3), engine.submit([4, 5], 3)]
        engine._admit()
        engine._work_once()
        if layout == "paged":
            assert engine.pool.cached_blocks() == 0
            assert engine.pool.in_use() == 0
        again = engine.submit([1, 2, 3], 3)
        drive(engine, [again])
        outs.append(outcomes([warm] + failed + [again]))
        engine.stop()
    jobs = [(list(range(16)), 4), ([1, 2, 3], 3), ([4, 5], 3), ([1, 2, 3], 3)]
    hold(weights, jobs, *outs)
    assert outs[1][1:3] == ["RuntimeError", "RuntimeError"]


def test_dense_admit_evict_and_cancels(weights):
    """tests/test_engine.py's slot scheduling on the dense grid: FIFO
    admission into the lowest free slot, eviction the moment a request
    ends, a cancel mid-decode and one while queued; slot reuse over a
    previous occupant's stale cache rows."""
    jobs = [([1, 2, 3], 2), ([4, 5, 6, 7], 4), ([8, 9], 2), ([6, 7], 12), ([5, 6], 4)]
    ref, port = engines(weights, n_slots=2, kv_layout="dense")
    outs = []
    for engine in (ref, port):
        handles = [engine.submit(row, new) for row, new in jobs]
        handles[4].cancel()  # while queued: never occupies a slot
        engine._admit()
        assert engine.slots() == (handles[0], handles[1])
        for _ in range(4):
            engine._step_once()
        assert engine.slots() == (None, handles[1])
        engine._admit()
        assert engine.slots() == (handles[2], handles[1])
        engine._step_once()
        handles[1].cancel()  # mid-decode
        engine._evict_cancelled()
        drive(engine, handles)
        outs.append(outcomes(handles))
        assert engine.cancelled == 2
        engine.stop()
    hold(weights, jobs, *outs)
    assert outs[1][1] == outs[1][4] == "cancelled"
    assert port.step.compiles == 1


def test_threaded_engine_matches_inline_and_captures_once(weights):
    """start=True: the engine thread runs the loop; mixed requests from
    client threads each equal their inline chain; one capture a program."""
    model = weights[2]
    eng = torch_engine.ContinuousBatchingEngine(
        model, n_slots=3, kv_layout="paged", block_size=8, prefill_chunk=8, device="cpu",
    )
    rng = np.random.default_rng(1234)
    jobs = [(rng.integers(0, 512, size=int(n)).tolist(), int(new))
            for n, new in rng.integers((1, 1), (40, 6), size=(9, 2))]
    results = [None] * len(jobs)

    def client(i):
        results[i] = eng.submit(*jobs[i]).result(120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(jobs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
    for (row, new), got in zip(jobs, results):
        assert got == inline(model, row, new)
    assert (eng.step.compiles, eng.step.prefill_compiles) == (1, 1)
    assert not eng.thread.is_alive()
    eng.pool.check()


def test_drain_swap_resume_copies_weights_in_place(weights):
    """The rolling update: in-flight work finishes on the old weights,
    work queued through the drain decodes on the new ones, copied into the
    model's own tensors (their storage never moves: a captured program
    keeps reading it), with no second capture."""
    jcfg, params, model = weights
    model = torch_gpt.GPT(model.cfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    other = torch_gpt.GPT(model.cfg, generator=torch.Generator().manual_seed(3))
    old_model = torch_gpt.GPT(model.cfg)
    old_model.load_state_dict(model.state_dict())
    eng = torch_engine.ContinuousBatchingEngine(model, n_slots=2, device="cpu", block_size=8)
    addresses = [t.data_ptr() for t in model.state_dict().values()]
    try:
        r1 = eng.submit([1, 2, 3], 6)
        stream = r1.stream(timeout=120)
        next(stream)
        eng.pause_admission()
        with pytest.raises(RuntimeError, match="drained"):
            eng.swap_params(other.state_dict())
        r2 = eng.submit([4, 5], 3)
        assert eng.drain(timeout=120)
        assert r1.result(1) == inline(old_model, [1, 2, 3], 6)
        eng.swap_params(other.state_dict())
        eng.resume_admission()
        assert r2.result(120) == inline(other, [4, 5], 3)
        assert [t.data_ptr() for t in model.state_dict().values()] == addresses
        assert eng.step.compiles == 1
    finally:
        eng.stop()


def test_pause_admission_closes_the_window_before_admit(weights):
    """The engine thread is held after its loop has read the admission gate
    (still open) and before _admit runs; meanwhile the caller pauses
    admission and submits. The request must not be placed until
    resume_admission: the drain finishes the first stream alone, and after
    the swap the second decodes on the new weights."""
    jcfg, params, model = weights
    model = torch_gpt.GPT(model.cfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    other = torch_gpt.GPT(model.cfg, generator=torch.Generator().manual_seed(3))
    old_model = torch_gpt.GPT(model.cfg)
    old_model.load_state_dict(model.state_dict())
    eng = torch_engine.ContinuousBatchingEngine(model, n_slots=2, device="cpu", block_size=8)
    armed, reached, release = threading.Event(), threading.Event(), threading.Event()
    admit = eng._admit

    def held_admit():
        if armed.is_set():
            armed.clear()
            reached.set()
            assert release.wait(120)
        admit()

    eng._admit = held_admit
    try:
        r1 = eng.submit([1, 2, 3], 6)
        stream = r1.stream(timeout=120)
        next(stream)
        armed.set()
        assert reached.wait(120)  # the loop read the open gate; _admit waits
        eng.pause_admission()
        r2 = eng.submit([4, 5], 3)
        release.set()
        assert eng.drain(timeout=120)
        assert eng.admitted == 1 and eng.queue_depth == 1
        assert r1.result(1) == inline(old_model, [1, 2, 3], 6)
        eng.swap_params(other.state_dict())
        eng.resume_admission()
        assert r2.result(120) == inline(other, [4, 5], 3)
        assert eng.admitted == 2
    finally:
        release.set()
        eng.stop()


def test_stop_mid_stream_fails_fast(weights):
    import time

    eng = torch_engine.ContinuousBatchingEngine(weights[2], n_slots=1, device="cpu",
                                                block_size=8)
    blocker = eng.submit([1, 2], 100)
    queued = eng.submit([3, 4], 4)
    stream = blocker.stream(timeout=120)
    next(stream)
    started = time.monotonic()
    eng.stop()
    for req in (blocker, queued):
        with pytest.raises(RuntimeError, match="stopped"):
            req.result(30)
    assert time.monotonic() - started < 15
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2], 2)
