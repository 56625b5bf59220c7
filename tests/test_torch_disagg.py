"""Disaggregated prefill/decode in the port's engine
(tf_operator_tpu_torch/serve/engine.py: export_prefix_blocks,
import_prefix_blocks, prefix_digest, kv_statz; serve/prefix.py
block_prefix_hashes) held against the JAX package's engine on the CPU, in
f32, on the same weights (models/convert.py), as tests/test_disagg.py
holds the reference's.

A KV block set crosses between the two packages in both directions: the
port's payload has the reference's leaf count, order, dtypes, shapes,
tokens and block count, its values within PAYLOAD_ATOL (int8 codes within
one step, where the two frameworks' f32 K/V fall on either side of a
rounding edge), at GPT_TINY and at a narrow 12-layer config (where the
layer names' string order, layer_0, layer_1, layer_10, ..., differs from
their number order), with and without int8 KV. The chain decoded after an
import equals the reference engine's and the port's inline generate, and
the importing engine prefills only the tail. Engines are built with
start=False and driven by hand (their ops run inline), so the file needs
no thread and no sleep.
"""

import base64
import dataclasses
import re

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.serve import engine as jax_engine
    from tf_operator_tpu.serve import prefix as jax_prefix
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.serve import engine as torch_engine
from tf_operator_tpu_torch.serve.prefix import block_prefix_hashes, prefix_hash
from tf_operator_tpu_torch.telemetry.flight import default_flight
from torch_threads import one_torch_thread  # noqa: F401

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed")

BS = 8  # block_size small enough that short prompts span whole blocks
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8]
# 19 tokens at BS=8: two full (migratable) blocks + a 3-token tail
NEW = 12
# f32 K/V of the two frameworks on the same weights (read: 1.9e-6 at
# GPT_TINY; the int8 scales of the 12-layer config 2.4e-6 on values ~0.1)
PAYLOAD_ATOL = 2e-6
PAYLOAD_RTOL = 2e-5

# (config name, kv_quant_int8)
CASES = [("tiny", False), ("tiny", True), ("deep", False), ("deep", True)]


def _configs(name):
    """(reference f32 cfg, port f32 cfg): GPT_TINY, or a narrow 12-layer
    variant of it."""
    extra = {} if name == "tiny" else dict(num_layers=12, hidden_size=64,
                                           intermediate_size=128)
    return (dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32, **extra),
            dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32, **extra))


def _engine_kw(kv_int8):
    return dict(n_slots=2, block_size=BS, prefill_chunk=BS, kv_quant_int8=kv_int8)


def drive(engine, handles, max_iters=2000):
    """The scheduler loop, by hand: admit, evict, one quantum."""
    for _ in range(max_iters):
        if all(h.done.is_set() for h in handles):
            return
        engine._admit()
        engine._evict_cancelled()
        if engine.active_slots:
            engine._work_once()
    raise AssertionError("drive() did not converge")


def run(engine, row, new):
    handle = engine.submit(list(row), new)
    drive(engine, [handle])
    return handle.result(1)


def inline(model, row, new, kv_int8=False):
    return torch_gpt.generate(model, torch.tensor([row]), new,
                              kv_quant_int8=kv_int8)[0].tolist()


def decode_leaf(enc):
    """A payload leaf as float64 numbers (bf16 travels as its int16 bits)."""
    raw = base64.b64decode(enc["data"])
    return np.frombuffer(raw, np.dtype(enc["dtype"])).astype(np.float64).reshape(enc["shape"])


def _random_params(jcfg, seed=0):
    """The reference GPT's params tree for jcfg, drawn with numpy from a
    seed (its shapes from jax.eval_shape: no init program is compiled),
    LayerNorm scales near 1 and every other leaf N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: jax_gpt.GPT(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


class World:
    """One config on both packages: the weights, a reference engine and a
    port engine that have each prefilled PROMPT, and their payloads."""

    def __init__(self, name, kv_int8):
        jcfg, tcfg = _configs(name)
        self.params = _random_params(jcfg)
        self.jcfg = jcfg
        self.model = torch_gpt.GPT(tcfg)
        self.model.load_state_dict(gpt_state_dict_from_flax(self.params))
        self.kv_int8 = kv_int8
        self.kw = _engine_kw(kv_int8)
        self.ref = jax_engine.ContinuousBatchingEngine(jcfg, self.params, start=False,
                                                       **self.kw)
        self.port = self.port_engine()
        for engine in (self.ref, self.port):
            run(engine, PROMPT, 1)
        self.ref_payload = self.ref.export_prefix_blocks(PROMPT)
        self.port_payload = self.port.export_prefix_blocks(PROMPT)

    def inline(self, row, new):
        return inline(self.model, row, new, self.kv_int8)

    def port_engine(self, **kw):
        return torch_engine.ContinuousBatchingEngine(self.model, start=False, device="cpu",
                                                     **{**self.kw, **kw})


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{'int8' if q else 'f32'}"
                                                   for n, q in CASES])
def world(request):
    if jax is None:
        pytest.skip("JAX is not installed")
    return World(*request.param)


@pytest.fixture(scope="module")
def tiny_world():
    if jax is None:
        pytest.skip("JAX is not installed")
    return World("tiny", False)


# -- the payload ----------------------------------------------------------------


def test_payload_matches_the_reference(world):
    """Leaf count, order, dtypes and shapes, tokens and blocks equal the
    reference engine's payload for the same prompt; the values within
    PAYLOAD_ATOL (int8 codes within one step)."""
    want, got = world.ref_payload, world.port_payload
    assert set(got) == set(want) == {"block_size", "blocks", "tokens", "leaves"}
    assert (got["block_size"], got["blocks"], got["tokens"]) == (BS, 2, PROMPT[:16])
    assert (want["block_size"], want["blocks"], want["tokens"]) == (BS, 2, PROMPT[:16])
    assert len(got["leaves"]) == len(want["leaves"])
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        assert (g["dtype"], g["shape"]) == (w["dtype"], w["shape"]), i
        diff = np.abs(decode_leaf(g) - decode_leaf(w))
        if g["dtype"] == "int8":
            assert diff.max() <= 1, i
        else:
            np.testing.assert_allclose(decode_leaf(g), decode_leaf(w), atol=PAYLOAD_ATOL,
                                       rtol=PAYLOAD_RTOL, err_msg=f"leaf {i}")


def test_leaves_follow_the_reference_tree_order(world):
    """cache_leaves names the reference's tree_flatten paths one for one:
    layers in string order of their names, k (k_scale) v (v_scale)."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(world.ref._cache)[0]]
    cache = world.port.step.cache
    names = {}
    for i, (k, v, ks, vs) in enumerate(cache.layers()):
        for kind, t in (("k", k), ("v", v), ("k_scale", ks), ("v_scale", vs)):
            if t is not None:
                names[id(t)] = f"['layer_{i}']['attention']['{kind}']"
    assert [names[id(t)] for t in torch_engine.cache_leaves(cache)] == paths
    if len(cache.keys) == 12:
        per = 4 if cache.quantized else 2  # leaves a layer
        assert paths[per].startswith("['layer_1']")
        assert paths[2 * per].startswith("['layer_10']")


def test_reference_payload_imports_into_the_port(world):
    """The reference's block set admitted by a fresh port engine: both
    blocks cached at refcount 1, and the chain decoded after it equals
    the reference engine's and the inline generate's, with no prefill
    chunk (the 3-token tail rides the forcing rule)."""
    port = world.port_engine()
    assert port.import_prefix_blocks(world.ref_payload) == 2
    got = run(port, PROMPT, NEW)
    assert got == run(world.ref, PROMPT, NEW) == world.inline(PROMPT, NEW)
    assert port.prefill_chunks == 0
    assert (port.pool.hits, port.pool.hit_tokens) == (2, 16)
    port.pool.check()
    assert port.pool.in_use() == 0


def test_port_payload_imports_into_the_reference(world):
    """The port's block set admitted by the reference engine, its pool
    flushed and zeroed first (so only the import can supply the prefix):
    the chain equals the port's inline generate, with the tail alone to
    prefill."""
    ref = world.ref
    ref.pool.flush()
    ref._cache = ref.step.init_cache()
    chunks = ref.prefill_chunks
    assert ref.import_prefix_blocks(world.port_payload) == 2
    assert run(ref, PROMPT, NEW) == world.inline(PROMPT, NEW)
    assert ref.prefill_chunks == chunks
    ref.pool.check()


def test_long_tail_prefills_only_past_the_import(tiny_world):
    """A 43-token prompt whose two leading blocks arrive by import (the
    port's own block set, so that under int8 KV the codes are the ones a
    cold engine writes): the importing engine runs two chunks fewer than a
    cold one, and the chains equal each other and the inline generate."""
    long = PROMPT[:16] + [(7 * i + 2) % 512 for i in range(27)]
    port = tiny_world.port_engine()
    assert port.import_prefix_blocks(tiny_world.port_payload) == 2
    got = run(port, long, 6)
    cold = tiny_world.port_engine()
    assert got == run(cold, long, 6) == tiny_world.inline(long, 6)
    # 43 tokens: 5 full blocks; the import saves the first 2 of them
    assert cold.prefill_chunks - port.prefill_chunks == 2
    assert port.pool.hit_tokens == 16


# -- import semantics (the port engine alone, as tests/test_disagg.py) --------


def test_import_refcounts_keys_and_digest(tiny_world):
    dst = tiny_world.port_engine()
    assert dst.import_prefix_blocks(tiny_world.port_payload) == 2
    pool = dst.pool
    for j in (1, 2):
        block = pool._cached.get(tuple(PROMPT[:j * BS]))
        assert block is not None and block != 0
        # refcount 1 = the cache's own reference only (idle, reclaimable)
        assert pool._ref[block] == 1
    pool.check()
    assert pool.in_use() == 0
    assert (dst.migrations_in, dst.kv_blocks_imported) == (1, 2)
    digest = set(dst.prefix_digest())
    assert {prefix_hash(PROMPT[:8]), prefix_hash(PROMPT[:16])} <= digest


def test_import_is_idempotent(tiny_world):
    dst = tiny_world.port_engine()
    assert dst.import_prefix_blocks(tiny_world.port_payload) == 2
    # a second import keeps the existing blocks authoritative
    assert dst.import_prefix_blocks(tiny_world.port_payload) == 2
    assert (dst.kv_blocks_imported, dst.migrations_in) == (2, 2)
    for j in (1, 2):
        assert dst.pool._ref[dst.pool._cached[tuple(PROMPT[:j * BS])]] == 1
    dst.pool.check()


def test_import_on_a_short_pool_evicts_no_live_work(tiny_world):
    """A pool of 4 usable blocks, all held by a live request: the import
    writes nothing and caches nothing (a short pool stops the walk rather
    than evicting live work); the request decodes its inline chain, and
    once it has released its blocks the same payload imports whole."""
    dst = tiny_world.port_engine(kv_blocks=4)
    row = list(range(20, 45))
    live = dst.submit(row, 8)  # 25 + 8 - 1 = 32 tokens: 4 blocks
    dst._admit()
    held = list(dst._slot_blocks[0])
    assert len(held) == 4 and dst.pool.available() == 0
    assert dst.import_prefix_blocks(tiny_world.port_payload) == 0
    assert (dst.kv_blocks_imported, dst.pool.cached_blocks()) == (0, 0)
    assert all(dst.pool._ref[b] == 1 for b in held)
    drive(dst, [live])
    assert live.result(1) == tiny_world.inline(row, 8)
    assert dst.import_prefix_blocks(tiny_world.port_payload) == 2
    assert dst.kv_blocks_imported == 2
    dst.pool.check()


def _tamper(payload, case):
    leaves = payload["leaves"]
    if case == "block_size":
        return {**payload, "block_size": BS * 2}
    if case == "tokens":
        return {**payload, "tokens": PROMPT[:3]}
    if case == "blocks":
        return {**payload, "blocks": 0}
    if case == "leaf_count":
        return {**payload, "leaves": leaves[:1]}
    if case == "dtype":
        return {**payload, "leaves": [{**leaves[0], "dtype": "float16"}] + leaves[1:]}
    if case == "shape":
        return {**payload, "leaves": [{**leaves[0], "shape": [2, BS, 2]}] + leaves[1:]}
    raise ValueError(case)


@pytest.mark.parametrize("case, text", [
    ("block_size", "block_size mismatch: payload 16, pool 8"),
    ("tokens", "malformed KV block-set payload"),
    ("blocks", "malformed KV block-set payload"),
    ("leaf_count", "cache structure mismatch: payload has 1 leaves, engine has 4"),
    ("dtype", "cache leaf mismatch: payload float16[2, 8, 2, 64], engine float32[2, 8, 2, 64]"),
    ("shape", "cache leaf mismatch: payload float32[2, 8, 2], engine float32[2, 8, 2, 64]"),
])
def test_import_rejects_mismatched_payloads(tiny_world, case, text):
    """Each mismatch is the reference's ValueError, in its words (the
    reference engine raises the same text for the same payload), and
    leaves the pool untouched."""
    bad = _tamper(tiny_world.port_payload, case)
    dst = tiny_world.port_engine()
    with pytest.raises(ValueError, match=re.escape(text)):
        dst.import_prefix_blocks(bad)
    assert dst.pool.cached_blocks() == 0 and dst.migrations_in == 0
    dst.pool.check()
    if case not in ("dtype", "shape"):
        # the reference words its dtype and shape checks the same way
        # through ml_dtypes' names; these four it raises before any leaf
        with pytest.raises(ValueError, match=re.escape(text)):
            tiny_world.ref.import_prefix_blocks(bad)


def test_export_of_an_unknown_prompt_is_none(tiny_world):
    """No published full-block prefix, no block set: an unseen prompt and
    a sub-block one; the sentinel block 0 is never exported."""
    port = tiny_world.port_engine()
    assert port.export_prefix_blocks([42] * 16) is None
    run(port, [7, 7, 7], 1)
    assert port.export_prefix_blocks([7, 7, 7]) is None
    assert (port.migrations_out, port.kv_blocks_exported) == (0, 0)
    pool = tiny_world.port.pool
    assert 0 not in [pool._cached[tuple(PROMPT[:j * BS])] for j in (1, 2)]


def test_mid_stream_continuation_across_migration(tiny_world):
    """The router's failover replay composed with migration: the first k
    tokens stream on one engine, the continuation (prompt + emitted)
    migrates and finishes on the other, and the stitched chain equals the
    inline generate."""
    src, dst = tiny_world.port_engine(), tiny_world.port_engine()
    new, k = 10, 4
    req = src.submit(list(PROMPT), new)
    while len(req.tokens) < k:
        src._admit()
        src._work_once()
    req.cancel()
    drive(src, [req])
    continuation = list(PROMPT) + req.tokens[:k]
    run(src, continuation, 1)
    payload = src.export_prefix_blocks(continuation)
    assert payload["blocks"] == len(continuation) // BS
    dst.import_prefix_blocks(payload)
    rest = run(dst, continuation, new - k)
    assert rest == tiny_world.inline(PROMPT, new)


def test_counters_flight_records_digest_and_statz(tiny_world):
    """The migration counters reach metrics() under the reference's
    names; each export and import leaves its flight record; the digest and
    the residency page equal the reference engine's after the same ops."""
    flight = default_flight()
    src = tiny_world.port_engine()
    run(src, PROMPT, 1)
    payload = src.export_prefix_blocks(PROMPT, corr="mig-1")
    dst = tiny_world.port_engine()
    dst.import_prefix_blocks(payload, corr="mig-1")
    flat_src = {name: value for (name, _), value in src.metrics().items()}
    flat_dst = {name: value for (name, _), value in dst.metrics().items()}
    assert (flat_src["engine_kv_blocks_exported_total"],
            flat_src["engine_migrations_out_total"]) == (2, 1)
    assert (flat_dst["engine_kv_blocks_imported_total"],
            flat_dst["engine_migrations_in_total"]) == (2, 1)
    assert set(torch_engine.METRIC_HELP) >= set(flat_src) | set(flat_dst)
    ops = [r.fields for r in flight.snapshot(kind="serve") if r.corr == "mig-1"]
    assert [o["op"] for o in ops][-2:] == ["kv-export", "kv-import"]
    assert ops[-1]["written"] == 2 and ops[-2]["tokens"] == 16
    ref = jax_engine.ContinuousBatchingEngine(tiny_world.jcfg, tiny_world.params, start=False,
                                              **tiny_world.kw)
    ref.import_prefix_blocks(payload)
    assert dst.prefix_digest() == ref.prefix_digest()
    assert dst.kv_statz(top_n=4) == ref.kv_statz(top_n=4)


# -- pool audits (tests/test_disagg.py TestPoolAudits) -------------------------


def test_drain_and_stop_audit_clean(tiny_world):
    """BlockPool.check() runs on drain and on stop, flight-recorded."""
    flight = default_flight()
    eng = tiny_world.port_engine()
    run(eng, PROMPT, 2)
    assert eng.drain(timeout=10.0)
    audits = [r.fields for r in flight.snapshot(kind="serve")
              if r.fields.get("op") == "pool-audit"]
    assert audits[-1]["where"] == "drain" and audits[-1]["ok"] is True
    eng.resume_admission()
    eng.stop()
    audits = [r.fields for r in flight.snapshot(kind="serve")
              if r.fields.get("op") == "pool-audit"]
    assert audits[-1]["where"] == "stop" and eng.pool_audit_failures == 0


def test_corrupt_pool_surfaces_as_a_counter(tiny_world):
    """A broken invariant is a counter and a flight record, not an
    unhandled assertion."""
    eng = tiny_world.port_engine()
    eng.pool._ref[0] = 0
    try:
        assert eng.audit_pool("test") is False
        assert eng.pool_audit_failures == 1 and "sentinel" in eng.pool_audit_error
        flat = {name: value for (name, _), value in eng.metrics().items()}
        assert flat["engine_pool_audit_failures_total"] == 1
    finally:
        eng.pool._ref[0] = 1


# -- the hash vocabulary ----------------------------------------------------------


@pytest.mark.parametrize("n, block_size, limit", [
    (29, 8, 32), (64, 8, 32), (100, 4, 2), (3, 8, 32), (0, 8, 32), (17, 1, 5), (40, 0, 32),
])
def test_block_prefix_hashes_equal_the_reference(n, block_size, limit):
    """The router's and the digest's shared vocabulary: equal to the
    reference's hashes for the same tokens, each the prefix_hash of its
    block-aligned prefix."""
    row = [int(t) for t in np.random.default_rng(n).integers(0, 32000, n)]
    got = block_prefix_hashes(row, block_size, limit)
    if jax is not None:
        assert got == jax_prefix.block_prefix_hashes(row, block_size, limit)
        assert prefix_hash(row) == jax_prefix.prefix_hash(row)
    full = min(n // block_size, limit) if block_size >= 1 else 0
    assert got == [prefix_hash(row[:(j + 1) * block_size]) for j in range(full)]


def test_hash_is_value_sensitive():
    assert prefix_hash([1, 2, 3]) != prefix_hash([1, 2, 4])
    assert prefix_hash([1, 2, 3]) != prefix_hash([1, 2])
    # tuples and lists hash alike (the cache keys are tuples)
    assert prefix_hash((1, 2, 3)) == prefix_hash([1, 2, 3])
