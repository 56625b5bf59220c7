"""The port's serving path (tf_operator_tpu_torch/models/gpt.py's slot and
paged decode steps, serve/engine.py's BlockPool, serve/server.py and
serve/client.py) held against the JAX package's on the CPU, in f32, on the
same weights (the flax params carried across with models/convert.py) and
the same numpy tokens and block tables.

Tolerances: next tokens equal; KV caches and pools within 1e-5 absolute
(the f32 differences of two frameworks summing the same products in other
orders through 2 layers, as tests/test_torch_gpt.py's decode tests). The
engine's chains against the reference engine's are in
tests/test_torch_serve_engine.py. On the CPU each program of a step runs
eagerly and its counter counts the first call; on a card it is a CUDA
graph captured once, which chip_smoke.py's `serve` phase holds. The
serving artifact (serve/export.py) is held here too: its int8 bytes
against quantize_model and the reference's quantize_params, and a server
on it against --weights-int8 (tests/test_torch_disagg.py and
tests/test_torch_router.py hold disaggregated serving).
"""

import ast
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.controller.clock import FakeClock as RefFakeClock
    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.serve import engine as jax_engine
    from tf_operator_tpu.serve import server as jax_server
    from tf_operator_tpu.telemetry.history import MetricHistory as RefMetricHistory
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.controller.clock import FakeClock
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.ops import quant as torch_quant
from tf_operator_tpu_torch.serve import engine as torch_engine
from tf_operator_tpu_torch.serve import server as torch_server
from tf_operator_tpu_torch.serve.client import DecodeClient, DecodeError
from tf_operator_tpu_torch.telemetry import validate_text
from tf_operator_tpu_torch.telemetry.history import MetricHistory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ATOL = 1e-5
BLOCKED = ("jax", "flax", "optax", "orbax", "tf_operator_tpu")
NEW_MODULES = (
    "tf_operator_tpu_torch.serve", "tf_operator_tpu_torch.serve.__main__",
    "tf_operator_tpu_torch.serve.engine", "tf_operator_tpu_torch.serve.server",
    "tf_operator_tpu_torch.serve.client", "tf_operator_tpu_torch.serve.prefix",
    "tf_operator_tpu_torch.runtime.retry", "tf_operator_tpu_torch.telemetry.tracing",
    "tf_operator_tpu_torch.telemetry.exposition", "tf_operator_tpu_torch.models.gpt",
    "tf_operator_tpu_torch.models.moe", "tf_operator_tpu_torch.ops.quant",
    "tf_operator_tpu_torch.serve.batching", "tf_operator_tpu_torch.telemetry.history",
    "tf_operator_tpu_torch.telemetry.alerts", "tf_operator_tpu_torch.telemetry.profiler",
    "tf_operator_tpu_torch.serve.router", "tf_operator_tpu_torch.serve.export",
    "tf_operator_tpu_torch.serve.fleet", "tf_operator_tpu_torch.serve.autoscaler",
    "tf_operator_tpu_torch.serve.observatory", "tf_operator_tpu_torch.telemetry.collector",
    "tf_operator_tpu_torch.controller.serve", "tf_operator_tpu_torch.controller.status",
    "tf_operator_tpu_torch.runtime.substrate", "tf_operator_tpu_torch.runtime.control",
    "tf_operator_tpu_torch.runtime.events", "tf_operator_tpu_torch.runtime.expectations",
    "tf_operator_tpu_torch.runtime.workqueue", "tf_operator_tpu_torch.api.k8s",
    "tf_operator_tpu_torch.api.serde", "tf_operator_tpu_torch.api.validation",
    "tf_operator_tpu_torch.api.defaults", "tf_operator_tpu_torch.telemetry",
    "tf_operator_tpu_torch.telemetry.__main__", "tf_operator_tpu_torch.telemetry.flight",
    "tf_operator_tpu_torch.telemetry.registry",
)


@pytest.fixture(scope="module")
def weights():
    """(reference f32 cfg, flax params, port f32 model) on one set of
    weights."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    model = torch_gpt.GPT(tcfg)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return jcfg, params, model


@pytest.fixture(scope="module")
def tiny():
    """The port's GPT_TINY (bf16 compute) with random weights from a seed."""
    return torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(0))


def _grid(seed, n, total, lens):
    """A right-padded prompt grid [n, total] with each row's tokens."""
    rng = np.random.default_rng(seed)
    prompt = np.zeros((n, total), np.int32)
    for i, length in enumerate(lens):
        prompt[i, :length] = rng.integers(0, 512, length)
    return prompt, np.asarray(lens, np.int32)


def _pool_close(jcache, pool, blocks=slice(None)):
    for layer in range(len(pool.keys)):
        attn = jcache[f"layer_{layer}"]["attention"]
        for name, got in (("k", pool.keys[layer]), ("v", pool.values[layer])):
            np.testing.assert_allclose(got.numpy()[blocks], np.asarray(attn[name])[blocks],
                                       atol=OUT_ATOL, err_msg=f"layer {layer} {name}")


def test_slot_step_matches_jax(weights):
    """SlotDecodeStep over a ragged 3-row grid for 12 steps (rows inside
    their prompts forced, then greedy, one row idle at a 1-token prompt):
    next tokens equal each step, the caches within OUT_ATOL."""
    jcfg, params, model = weights
    n, total = 3, 32
    prompt, lens = _grid(0, n, total, [5, 9, 1])
    jstep = jax_gpt.SlotDecodeStep(jcfg, n, total)
    jcache = jstep.init_cache()
    step = torch_gpt.SlotDecodeStep(model, n, total)
    step.init_cache()
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    for i in range(12):
        jcache, want = jstep(params, jcache, tok, index, prompt, lens)
        got = step(tok, index, prompt, lens).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"step {i}")
        tok, index = got.astype(np.int32), index + 1
    _pool_close(jcache, step.cache)
    assert step.compiles == 1
    assert step.kv_bytes_total == 2 * 2 * n * total * 128 * 4


def _paged_case(seed=1):
    """3 slots over 13 blocks of 8 (block 0 the sentinel), each slot's
    4-block table a seeded draw of distinct blocks."""
    n, total, bs, nb = 3, 32, 8, 13
    prompt, lens = _grid(seed, n, total, [5, 9, 1])
    perm = np.random.default_rng(seed).permutation(np.arange(1, nb))
    tables = perm[:n * (total // bs)].reshape(n, total // bs).astype(np.int32)
    return n, total, bs, nb, prompt, lens, tables


def test_paged_step_matches_jax(weights):
    """PagedSlotDecodeStep for 12 steps through block tables: next tokens
    equal each step and equal the dense step's; the pool within OUT_ATOL
    outside the sentinel block (whose contents are garbage by contract)."""
    jcfg, params, model = weights
    n, total, bs, nb, prompt, lens, tables = _paged_case()
    jstep = jax_gpt.PagedSlotDecodeStep(jcfg, n, total, bs, nb)
    jcache = jstep.init_cache()
    step = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
    step.init_cache()
    dense = torch_gpt.SlotDecodeStep(model, n, total)
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    for i in range(12):
        jcache, want = jstep(params, jcache, tok, index, prompt, lens, tables)
        got = step(tok, index, prompt, lens, tables).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"step {i}")
        np.testing.assert_array_equal(got, dense(tok, index, prompt, lens).numpy())
        tok, index = got.astype(np.int32), index + 1
    _pool_close(jcache, step.cache, slice(1, None))
    assert step.compiles == 1
    assert step.kv_bytes_total == jstep.kv_bytes_total


def test_paged_prefill_and_copy_block_match_jax(weights):
    """A 5-token prefill chunk at position 3 of a slot's table, then a
    copy of one block into another: the pool within OUT_ATOL of the
    reference's after each; one first call per program."""
    jcfg, params, model = weights
    n, total, bs, nb, _, _, tables = _paged_case(2)
    jstep = jax_gpt.PagedSlotDecodeStep(jcfg, n, total, bs, nb)
    jcache = jstep.init_cache()
    step = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
    tokens = np.random.default_rng(3).integers(0, 512, (1, 5)).astype(np.int32)
    jcache = jstep.prefill(params, jcache, tokens, 3, tables[0])
    step.prefill(tokens, 3, tables[0])
    _pool_close(jcache, step.cache, slice(1, None))
    assert float(step.cache.keys[0][tables[0][0]].abs().sum()) > 0
    jcache = jstep.copy_block(jcache, int(tables[0][0]), 12)
    step.copy_block(int(tables[0][0]), 12)
    _pool_close(jcache, step.cache, slice(1, None))
    with pytest.raises(ValueError, match="chunk"):
        step.prefill(tokens[:, :4], 0, tables[0])
    assert (step.prefill_compiles, step.copy_compiles) == (1, 1)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_step_logits_are_gpt_decode_steps(weights, layout):
    """The logits a slot step exposes (an output of its program, which
    chip_smoke.py's `serve` phase holds on the card) are GPTDecodeStep's
    over a dense cache fed the same tokens, within OUT_ATOL, for 12 steps
    of the ragged grid; outside its prompt a row's next token is their
    argmax."""
    _, _, model = weights
    n, total, bs, nb, prompt, lens, tables = _paged_case()
    if layout == "paged":
        step = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
        run = lambda tok, index: step(tok, index, prompt, lens, tables)  # noqa: E731
    else:
        step = torch_gpt.SlotDecodeStep(model, n, total)
        run = lambda tok, index: step(tok, index, prompt, lens)  # noqa: E731
    ref = torch_gpt.GPTDecodeStep(model)
    cache = torch_gpt.KVCache.zeros(model.cfg, n, total)
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    for i in range(12):
        got = run(tok, index).numpy()
        want = ref(torch.as_tensor(tok).long(), torch.as_tensor(index).long(), cache)
        np.testing.assert_allclose(step.logits.numpy(), want.numpy(), atol=OUT_ATOL,
                                   err_msg=f"step {i}")
        free = index + 1 >= lens
        np.testing.assert_array_equal(got[free], step.logits.numpy()[free].argmax(-1))
        tok, index = got.astype(np.int32), index + 1


@pytest.mark.parametrize("option, error, match", [
    # a mesh is ported (tests/test_torch_sharded_serve.py); what stays
    # refused are the reference's own checks of the sharded step
    ({"mesh": (1, 4)}, ValueError, "num_heads 2 must divide over 4 'model' shards"),
    ({"mesh": (1, 2), "weights_int8": True}, ValueError,
     "weights_int8 is not supported on the sharded decode step"),
])
def test_paged_step_refuses_unported_options(tiny, option, error, match):
    """The sharded step's refusals, in the reference's words, over a mesh
    of shards sharing the CPU; int8 KV and the verify program are ported
    (tests/test_torch_quant.py, tests/test_torch_spec_decode.py)."""
    from tf_operator_tpu_torch.parallel.mesh import make_device_mesh

    shape = option["mesh"]
    option = dict(option, mesh=make_device_mesh(shape, devices=["cpu"] * (shape[0] * shape[1])))
    with pytest.raises(error, match=match):
        torch_gpt.PagedSlotDecodeStep(tiny, 2, 32, 8, 9, **option)


@pytest.mark.parametrize("kwargs, match", [
    (dict(max_total=36, block_size=8, num_blocks=9), "multiple of block_size"),
    (dict(max_total=32, block_size=8, num_blocks=1), "num_blocks"),
    (dict(max_total=256, block_size=8, num_blocks=9), "max_seq_len"),
])
def test_paged_step_validation(tiny, kwargs, match):
    with pytest.raises(ValueError, match=match):
        torch_gpt.PagedSlotDecodeStep(tiny, 2, **kwargs)


def _pool_ops(seed, n_ops=400):
    """A seeded table of BlockPool operations over a 12-block pool of 4
    tokens: alloc, retain, release (of a block the test holds), lookup
    and publish (of six token keys of one or two blocks, so they repeat),
    flush; the pool's own rules decide which are legal."""
    rng = np.random.default_rng(seed)
    keys = [tuple(int(t) for t in rng.integers(0, 512, size=4 * (1 + k % 2))) for k in range(6)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "retain", "release", "lookup", "publish", "flush"],
                          p=[0.25, 0.12, 0.3, 0.15, 0.15, 0.03])
        ops.append((str(kind), keys[int(rng.integers(6))], float(rng.random())))
    return ops


def _run_pool(pool, ops):
    """Apply `ops` to `pool`, keeping a list of held references; -> the
    trace of every result and counter."""
    held, trace = [], []
    for kind, key, pick in ops:
        if kind == "alloc":
            if pool.available() < 1:
                trace.append(("full",))
                continue
            block = pool.alloc()
            held.append(block)
            trace.append(("alloc", block))
        elif kind in ("retain", "release", "publish") and held:
            block = held[int(pick * len(held))]
            if kind == "retain":
                pool.retain(block)
                held.append(block)
            elif kind == "release":
                held.remove(block)
                pool.release(block)
            else:
                pool.publish(key, block)
            trace.append((kind, block))
        elif kind == "lookup":
            trace.append(("lookup", pool.lookup(key)))
        elif kind == "flush":
            pool.flush()
            trace.append(("flush",))
        pool.check()
        trace.append((pool.available(), pool.in_use(), pool.cached_idle(),
                      pool.cached_blocks(), pool.reclaimed))
    trace.append(pool.residency(top_n=5))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_matches_reference(seed):
    """The port's BlockPool against the reference's on one seeded table of
    alloc, retain, release, lookup, publish and flush operations: every
    result, counter and the residency page equal."""
    if jax is None:
        pytest.skip("JAX is not installed")
    ops = _pool_ops(seed)
    want = _run_pool(jax_engine.BlockPool(12, 4), ops)
    got = _run_pool(torch_engine.BlockPool(12, 4), ops)
    assert got == want
    assert any(t[0] == "lookup" and t[1] is not None for t in got if isinstance(t, tuple))


@pytest.mark.parametrize("option, match", [
    # mesh_shape is ported (tests/test_torch_sharded_serve.py): the
    # reference's refusal of it on the dense grid stays
    ({"mesh_shape": (1, 2), "kv_layout": "dense"}, "mesh_shape requires kv_layout='paged'"),
])
def test_engine_refuses_unported_options(tiny, option, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        torch_engine.ContinuousBatchingEngine(tiny, start=False, device="cpu", **option)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_engine_takes_a_role(tiny, role):
    """The role is advisory, as the reference's: it names the engine
    thread (decode-engine-<role>) and the engine serves as any other."""
    eng = torch_engine.ContinuousBatchingEngine(tiny, n_slots=2, block_size=8, prefill_chunk=8,
                                                device="cpu", role=role)
    try:
        assert eng.thread.name == f"decode-engine-{role}"
        assert eng.submit([5, 6, 7], 3).result(60) == _inline(tiny, [5, 6, 7], 3)
    finally:
        eng.stop()


@pytest.mark.parametrize("method, args, want", [
    ("export_prefix_blocks", ([1, 2],), "KV export requires kv_layout='paged'"),
    ("import_prefix_blocks", ({},), "KV import requires kv_layout='paged'"),
    ("prefix_digest", (), []), ("kv_statz", (), {"paged": False}),
])
def test_engine_disaggregated_methods_on_a_dense_engine(tiny, method, args, want):
    """A dense engine has no block set: export and import raise the
    reference's RuntimeError, the digest is empty and the residency page
    says so (tests/test_torch_disagg.py holds the paged engine's)."""
    eng = torch_engine.ContinuousBatchingEngine(tiny, start=False, device="cpu",
                                                kv_layout="dense")
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=re.escape(want)):
            getattr(eng, method)(*args)
    else:
        assert getattr(eng, method)(*args) == want
    eng.stop()


def test_engine_and_server_want_cuda(tiny):
    """Without device="cpu" both run on `cuda`, and without a card they
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_engine.ContinuousBatchingEngine(tiny, start=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_server.make_server(tiny, batching="continuous")


@pytest.mark.parametrize("option, text", [
    # mesh and mesh_shape are ported (tests/test_torch_sharded_serve.py,
    # tests/test_torch_tp_serve.py); the reference's refusals of their
    # combinations stay, in its words
    pytest.param({"mesh": object(), "batching": "continuous"},
                 "batching='continuous' and mesh are mutually exclusive", id="mesh-continuous"),
    pytest.param({"mesh": object(), "speculative": True},
                 "speculative and mesh are mutually exclusive", id="mesh-speculative"),
    pytest.param({"mesh_shape": (1, 2)}, "mesh_shape requires batching='continuous'",
                 id="mesh_shape-inline"),
    pytest.param({"mesh_shape": (1, 2), "batching": "continuous", "kv_layout": "dense"},
                 "mesh_shape requires kv_layout='paged'", id="mesh_shape-dense"),
])
def test_make_server_refuses_unported_options(tiny, option, text):
    with pytest.raises(ValueError, match=re.escape(text)):
        torch_server.make_server(tiny, device="cpu", **option)


@pytest.mark.parametrize("option, text", [
    ({"role": "mixed"}, "role must be '', 'prefill' or 'decode', got 'mixed'"),
    ({"role": "prefill", "batching": "continuous", "speculate": "ngram"},
     "speculate is decode-pool-only"),
])
def test_make_server_refuses_role_combinations(tiny, option, text):
    """The reference's role checks, in its words."""
    with pytest.raises(ValueError, match=re.escape(text)):
        torch_server.make_server(tiny, device="cpu", **option)


@pytest.mark.parametrize("option, wired", [
    ({"batching": "window", "batch_window_ms": 5.0}, "batcher"),
    ({"batch_window_ms": 5.0}, "batcher"),
    ({"tenant_quotas": {}}, "qos"),
    ({"enable_debug_endpoints": True}, "enable_debug"),
])
def test_make_server_takes_the_telemetry_options(tiny, option, wired):
    """The options ported with the telemetry plane: each is wired into the
    server, which then answers a greedy request with the inline chain;
    server_close() stops the history, alert and batcher threads."""
    srv = _serve(tiny, **option)
    try:
        assert getattr(srv.state, wired) not in (None, False)
        assert srv.state.history is not None and srv.state.alerts is not None
        status, body = _post(srv.server_address[1], "/generate",
                             {"input_ids": [[5, 6, 7]], "max_new_tokens": 3})
        assert status == 200 and body["tokens"] == [_inline(tiny, [5, 6, 7], 3)]
    finally:
        srv.shutdown()
        srv.server_close()
    if srv.state.batcher is not None:
        assert not srv.state.batcher.thread.is_alive()
    with pytest.raises(ValueError, match="needs batch_window_ms > 0"):
        torch_server.make_server(tiny, device="cpu", batching="window")


@pytest.mark.parametrize("argv, item", [
    # --tp and --mesh-shape are ported: the reference's refusals of their
    # combinations stay
    pytest.param(["--tp", "2", "--speculative"], "--tp is mutually exclusive with --speculative",
                 id="tp-speculative"),
    pytest.param(["--mesh-shape", "1x2"], "--mesh-shape requires --batching continuous",
                 id="mesh-shape-inline"),
    pytest.param(["--batching", "continuous", "--mesh-shape", "1x2", "--weights-int8"],
                 "--mesh-shape and --weights-int8 are mutually exclusive", id="mesh-shape-int8"),
    pytest.param(["--batching", "continuous", "--mesh-shape", "2"], "mesh_shape must be",
                 id="mesh-shape-malformed"),
    # the moe presets serve since the MoE slice (ROADMAP item 7); what they
    # refuse is the gpt family's options, in the reference's words
    pytest.param(["--preset", "moe-tiny", "--batching", "continuous"], "gpt-family features",
                 id="argv9-item 7"),
    pytest.param(["--preset", "moe-tiny", "--tp", "2"], "gpt-family features", id="moe-tp"),
])
def test_cli_refuses_unported_flags(argv, item, capsys):
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(argv)
    assert err.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("argv, want", [
    (["--batching", "window", "--batch-window-ms", "5"], {"batching": "window"}),
    (["--batch-window-ms", "5"], {"batching": "window", "batch_window_ms": 5.0}),
    (["--tenant-quotas", '{"noisy": {"rate": 100, "priority": "batch"}}'],
     {"tenant_quotas_parsed": {"noisy": {"rate": 100, "priority": "batch"}}}),
    (["--enable-debug-endpoints", "--history-interval", "0.5", "--history-capacity", "64",
      "--alerts", "off", "--ttft-slo-ms", "100"],
     {"enable_debug_endpoints": True, "history_interval": 0.5, "history_capacity": 64,
      "alerts": "off", "ttft_slo_ms": 100.0}),
])
def test_cli_takes_the_telemetry_flags(argv, want):
    args = torch_server.parse_args(argv)
    assert {name: getattr(args, name) for name in want} == want


@pytest.mark.parametrize("argv, role, text", [
    (["--role", "prefill", "--batching", "continuous"], "prefill", None),
    (["--role", "decode", "--batching", "continuous", "--speculate", "ngram"], "decode", None),
    (["--role", "prefill", "--batching", "continuous", "--speculate", "ngram"], None,
     "--speculate is decode-pool-only (a prefill replica never decodes)"),
    (["--role", "mixed"], None, "invalid choice: 'mixed'"),
])
def test_cli_role_flag(argv, role, text, capsys):
    """--role parses to the server's role; the reference's parser refuses
    speculation on a prefill replica and a role it does not know."""
    if text is None:
        assert torch_server.parse_args(argv).role == role
        return
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(argv)
    assert err.value.code == 2 and text in capsys.readouterr().err


@pytest.mark.parametrize("argv, text", [
    (["--batching", "window"], "--batching window needs --batch-window-ms > 0"),
    (["--batching", "continuous", "--batch-window-ms", "5"], "mutually exclusive with "
     "--batch-window-ms"),
    (["--tenant-quotas", '{"a": {"priority": "gold"}}'], "priority must be one of"),
    (["--tenant-quotas", "[1]"], "must be a JSON object"),
])
def test_cli_refuses_telemetry_flag_combinations(argv, text, capsys):
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(argv)
    assert err.value.code == 2 and text in capsys.readouterr().err


# -- the moe presets ------------------------------------------------------------

MOE_STARTUP = ("the moe family serves plain decode only: kv_quant_int8, weights_int8, "
               "speculative, batching (window/continuous) and mesh are gpt-family features")


@pytest.fixture(scope="module")
def moe_weights():
    """(reference MOE_TINY cfg, its flax params, the port's MoELM on them)."""
    if jax is None:
        pytest.skip("JAX is not installed")
    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu_torch.models import moe as torch_moe
    from tf_operator_tpu_torch.models.convert import moe_state_dict_from_flax

    init = jax.jit(jax_moe.MoELM(jax_moe.MOE_TINY).init)
    params = jax.tree_util.tree_map(
        np.array, init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    model = torch_moe.MoELM(torch_moe.MOE_TINY)
    model.load_state_dict(moe_state_dict_from_flax(params))
    return jax_moe.MOE_TINY, params, model


@pytest.fixture(scope="module")
def moe_server(moe_weights):
    server = torch_server.make_server(moe_weights[2], device="cpu", model_name="moe-tiny")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()


def test_moe_preset_serves_the_reference_chains(moe_weights, moe_server):
    """/generate and /generate_stream over MOE_TINY: greedy chains equal
    to the reference's moe_generate on the same weights, a sampled chain
    the port's moe_generate from the request's seed."""
    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu_torch.models import moe as torch_moe

    cfg, params, model = moe_weights
    port = moe_server.server_address[1]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 5)).tolist()
    want = np.asarray(jax_moe.moe_generate(cfg, params, jnp.asarray(prompt), 6)).tolist()
    status, body = _post(port, "/generate", {"input_ids": prompt, "max_new_tokens": 6})
    assert status == 200, body
    assert body["tokens"] == want and body["prompt_lens"] == [5, 5, 5]
    client = DecodeClient(f"http://127.0.0.1:{port}")
    events = list(client.generate_stream(prompt[0], max_new_tokens=6))
    assert events[-1]["tokens"] == [want[0]]
    assert [e["token"] for e in events if "token" in e] == want[0][5:]
    status, body = _post(port, "/generate", {"input_ids": prompt[:1], "max_new_tokens": 6,
                                            "temperature": 0.8, "seed": 4})
    gen = torch.Generator().manual_seed(4)
    sampled = torch_moe.moe_generate(model, torch.tensor(prompt[:1]), 6, temperature=0.8,
                                     generator=gen)
    assert status == 200 and body["tokens"] == sampled.tolist()
    status, body = _get(port, "/healthz")
    assert status == 200 and json.loads(body)["model"] == "moe-tiny"


@pytest.mark.parametrize("payload, text", [
    ({"input_ids": [[1, 2, 3], [4, 5]]},
     "the moe family requires uniform-length prompts (no ragged prompt_lens machinery "
     "in moe_generate)"),
    ({"input_ids": [[1, 2, 3]], "temperature": 0.5, "top_k": 4},
     "top_k/top_p are not supported for the moe family"),
    ({"input_ids": [[1, 2, 3]], "temperature": 0.5, "top_p": 0.9},
     "top_k/top_p are not supported for the moe family"),
    ({"input_ids": [[1, 2, 3]], "num_beams": 2}, "beam search is not supported for the moe family"),
    ({"input_ids": [[1, 2, 3]], "max_new_tokens": 126},
     "prompt_len 3 + max_new_tokens 126 exceeds max_seq_len 128"),
])
def test_moe_preset_refuses_requests_in_the_reference_words(moe_server, payload, text):
    status, body = _post(moe_server.server_address[1], "/generate", payload)
    assert status == 400 and body["error"] == text


@pytest.mark.parametrize("option", [
    {"batching": "continuous"}, {"batching": "window"}, {"kv_quant_int8": True},
    {"weights_int8": True}, {"speculative": True}, {"mesh": object()},
])
def test_moe_make_server_refuses_gpt_family_options(option):
    from tf_operator_tpu_torch.models import moe as torch_moe

    model = torch_moe.MoELM(torch_moe.MOE_TINY)
    with pytest.raises(ValueError, match="the moe family serves plain decode only"):
        torch_server.make_server(model, device="cpu", **option)


@pytest.mark.parametrize("argv", [
    ["--kv-int8"], ["--weights-int8"], ["--speculative"], ["--speculate", "ngram"],
    ["--batch-window-ms", "5"], ["--batching", "continuous"], ["--tp", "2"],
])
def test_moe_cli_refuses_gpt_family_flags(argv, capsys):
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(["--preset", "moe-base"] + argv)
    assert err.value.code == 2
    assert (f"{argv[0]} are gpt-family features; the moe presets serve plain greedy/sampled "
            "decode only") in capsys.readouterr().err


def test_moe_cli_loads_the_moe_checkpoint(tmp_path):
    """--preset moe-tiny --checkpoint-dir serves what train/moe.py wrote."""
    from tf_operator_tpu_torch.train import moe as moe_cli

    moe_cli.run(moe_cli.parse_args([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path)]))
    payload = torch.load(os.path.join(tmp_path, "2", "state.pt"), weights_only=True)
    model = torch_server.load_model("moe-tiny", str(tmp_path), torch.device("cpu"))
    assert type(model).__name__ == "MoELM"
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, payload["model"][name]), name


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.fixture(scope="module")
def servers(tiny):
    """A continuous-batching server (paged, a bounded 8-block pool of 8
    tokens: over-pool prompts must come back as 400s) and an inline one,
    on loopback, over the same model."""
    out = {}
    for batching in ("continuous", "none"):
        srv = torch_server.make_server(
            tiny, model_name="gpt-test", max_new_cap=64, batching=batching, n_slots=4,
            block_size=8, kv_blocks=8, prefill_chunk=8, device="cpu",
        )
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out[batching] = srv
    yield {name: srv.server_address[1] for name, srv in out.items()}
    for srv in out.values():
        srv.shutdown()
        srv.server_close()
        if srv.state.engine is not None:
            srv.state.engine.stop()
            assert not srv.state.engine.thread.is_alive()


def _inline(model, row, new):
    return torch_gpt.generate(model, torch.tensor([row]), new)[0].tolist()


@pytest.mark.parametrize("batching", ["continuous", "none"])
def test_generate_and_stream_agree(servers, tiny, batching):
    """/generate (a ragged batch of two) and /generate_stream (one row,
    one event per token) give the same tokens, equal to the inline
    generate; the stream's indices count from the prompt's end."""
    client = DecodeClient(f"http://127.0.0.1:{servers[batching]}", timeout=60)
    chains = client.generate([[5, 6, 7], [1, 2, 3, 4]], max_new_tokens=6)
    assert chains == [_inline(tiny, [5, 6, 7], 6), _inline(tiny, [1, 2, 3, 4], 6)]
    events = list(client.generate_stream([5, 6, 7], max_new_tokens=6))
    assert [e["index"] for e in events[:-1]] == list(range(3, 9))
    assert [e["token"] for e in events[:-1]] == chains[0][3:]
    assert events[-1]["done"] is True and events[-1]["tokens"] == [chains[0]]
    assert events[-1]["prompt_lens"] == [3]


def test_sampled_request_keeps_the_inline_path(servers, tiny):
    """A sampled request bypasses the engine (its finished counter does
    not move) and is the port's generate seeded with the request's seed."""
    client = DecodeClient(f"http://127.0.0.1:{servers['continuous']}", timeout=60)
    finished = "tf_operator_tpu_serve_engine_finished_total"
    before = client.metrics()[finished]
    got = client.generate([[3, 1, 4]], max_new_tokens=4, temperature=1.0, top_k=50, seed=3)
    want = torch_gpt.generate(
        tiny, torch.tensor([[3, 1, 4]]), 4, temperature=1.0, top_k=50,
        generator=torch.Generator().manual_seed(3), prompt_lens=torch.tensor([3]),
    )
    assert got == want.tolist()
    assert client.metrics()[finished] == before


def test_client_errors(servers):
    """An over-pool prompt is a 400 with the engine's message on both
    routes (it passes the generic max_seq_len check: 70 + 8 tokens need
    10 of the pool's 8 blocks); a multi-row stream, a malformed body and
    ragged beams are 400s; the client raises DecodeError."""
    port = servers["continuous"]
    for path in ("/generate", "/generate_stream"):
        status, body = _post(port, path, {"input_ids": [list(range(1, 71))], "max_new_tokens": 8})
        assert status == 400 and "KV blocks" in body["error"]
    status, body = _post(port, "/generate_stream", {"input_ids": [[1, 2], [3, 4]]})
    assert status == 400 and "exactly one prompt row" in body["error"]
    status, body = _post(port, "/generate", {"input_ids": [[1, 2], [3]], "num_beams": 2})
    assert status == 400 and body["error"] == "num_beams > 1 requires uniform-length prompts"
    assert _post(port, "/generate", {"input_ids": "nope"})[0] == 400
    client = DecodeClient(f"http://127.0.0.1:{port}", timeout=60)
    with pytest.raises(DecodeError) as err:
        client.generate([[600]], max_new_tokens=2)
    assert err.value.status == 400


def test_unported_routes_name_their_items(servers):
    """Every route of the reference is served now: the disaggregated
    routes answer (a sub-block prompt has no block set to export; an empty
    payload is the reference's 400), the debug routes are ported with
    /debug/profilez behind --enable-debug-endpoints, as in the reference,
    and an unknown route is a 404 (tests/test_torch_router.py holds the
    migration routes' behaviour)."""
    port = servers["continuous"]
    status, body = _get(port, "/kv/digest")
    assert status == 200 and json.loads(body)["block_size"] == 8
    status, body = _get(port, "/kv/statz")
    assert status == 200 and json.loads(body)["paged"] is True
    assert _get(port, "/debug/flightz")[0] == 200
    assert _get(port, "/debug/profilez")[0] == 404
    status, body = _post(port, "/kv/export", {"input_ids": [[1, 2]]})
    assert status == 200 and body["payload"] is None and body["blocks"] == 0
    status, body = _post(port, "/kv/import", {"input_ids": [[1, 2]]})
    assert status == 400 and body["error"] == "block_size mismatch: payload 0, pool 8"
    status, body = _post(port, "/prefill", {"input_ids": [[1, 2]]})
    assert status == 200 and body == {**body, "blocks": 0, "migrated": False, "imported": 0}
    assert _get(port, "/nope")[0] == 404


# -- the telemetry plane: tenant QoS, engine priority, window batching and
# -- the debug routes ---------------------------------------------------------

QUOTAS = {"noisy": {"rate": 10, "burst": 20, "priority": "batch"},
          "vip": {"priority": "high"}, "*": {"priority": "standard"}}


def _qos_script(qos_cls, clock, history):
    """Admissions against a scripted clock: the noisy tenant drains its
    bucket and is refused with a refill wait, refills, then every class
    meets queue pressure (a queue-wait p95 past its multiple of the
    SLO)."""
    qos = qos_cls(QUOTAS, ttft_slo_s=0.25, history=history, clock=clock)
    verdicts = []
    for tenant, cost, dt in (("noisy", 8, 0.0), ("noisy", 8, 0.1), ("noisy", 8, 0.1),
                             ("vip", 1000, 0.0), ("other", 50, 0.0), ("noisy", 8, 1.5),
                             ("noisy", 25, 0.0)):
        clock.advance(dt)
        verdicts.append(qos.admit(tenant, cost))
    series = "tf_operator_tpu_serve_queue_wait_seconds"
    history.ingest_histogram(series, [(0.25, 0.0), (0.5, 0.0), (1.0, 0.0), (float("inf"), 0)])
    clock.advance(1.0)
    history.ingest_histogram(series, [(0.25, 0.0), (0.5, 10.0), (1.0, 20.0),
                                      (float("inf"), 20.0)])
    for tenant in ("noisy", "other", "vip"):
        verdicts.append(qos.admit(tenant, 1))
    return verdicts, [qos.priority(t) for t in ("noisy", "vip", "other")]


def test_tenant_qos_decides_as_the_reference():
    if jax is None:
        pytest.skip("JAX is not installed")
    ref_clock, port_clock = RefFakeClock(), FakeClock()
    ref = _qos_script(jax_server.TenantQoS, ref_clock,
                      RefMetricHistory(capacity=16, clock=ref_clock))
    port = _qos_script(torch_server.TenantQoS, port_clock,
                       MetricHistory(capacity=16, clock=port_clock))
    assert port == ref
    verdicts, priorities = port
    assert [v["ok"] for v in verdicts[:7]] == [True, True, False, True, True, True, False]
    assert verdicts[2]["retry_after"] == pytest.approx(1.0)  # the floor: 0.2 s of refill
    assert verdicts[6]["retry_after"] == pytest.approx(1.3)  # (25 - 12 left) / 10 per s
    # queue pressure: p95 ~0.9 s sheds batch (1x 0.25) and standard (2x) but
    # not high (4x), each 429 with the projected wait
    assert [v["ok"] for v in verdicts[7:]] == [False, False, True]
    assert priorities == [0, 2, 1]
    with pytest.raises(ValueError, match="priority must be one of"):
        torch_server.TenantQoS({"a": {"priority": "gold"}})


def _stage_order(engine):
    """Submit a mix of priorities in two waves, each drained into the
    scheduler stage as the engine's admission does: -> the staged
    prompts' first token, in order."""
    waves = [[(1, 0), (2, 0), (3, 1), (4, 2), (5, 1)], [(6, 2), (7, 0), (8, 1), (9, 2)]]
    for wave in waves:
        for token, priority in wave:
            engine.submit([token, 11, 12], 2, priority=priority)
        while not engine._queue.empty():
            engine._stage(engine._queue.get_nowait())
    order = [req.prompt[0] for req in engine._pending]
    engine.stop()
    return order


def test_engine_stage_orders_priorities_as_the_reference(weights):
    jcfg, params, model = weights
    kw = dict(n_slots=2, kv_layout="paged", block_size=8, prefill_chunk=8)
    ref = _stage_order(jax_engine.ContinuousBatchingEngine(jcfg, params, start=False, **kw))
    port = _stage_order(torch_engine.ContinuousBatchingEngine(model, start=False,
                                                              device="cpu", **kw))
    assert port == ref
    # the head keeps its place; higher overtakes lower; equal stays FIFO
    assert port == [1, 4, 6, 9, 3, 5, 8, 2, 7]


def _post_many(port, rows, new, tenant=None):
    """Every row as its own /generate from its own thread: -> the chains
    and the statuses, in row order."""
    out = [None] * len(rows)

    def one(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"input_ids": [rows[i]], "max_new_tokens": new}).encode(),
            headers={"Content-Type": "application/json", **({"X-Tenant": tenant} if tenant
                                                            else {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                out[i] = (resp.status, json.loads(resp.read())["tokens"][0], None)
        except urllib.error.HTTPError as err:
            out[i] = (err.code, json.loads(err.read()), err.headers.get("Retry-After"))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    return out


WINDOW_ROWS = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9], [40], [300, 301, 302, 303, 304],
               [17, 18], [90, 91, 92, 93, 94, 95, 96, 97, 98, 99, 100, 101]]


def test_window_batched_chains_equal_the_reference_window_server(weights):
    """Six concurrent requests to each package's window server at f32 on
    one set of weights: the same chains, equal to the port's inline
    generate; the batcher formed the reference's padded group."""
    jcfg, params, model = weights
    port_srv = _serve(model, batching="window", batch_window_ms=200)
    ref_srv = jax_server.make_server(jcfg, params, batching="window", batch_window_ms=200,
                                     max_new_cap=64)
    threading.Thread(target=ref_srv.serve_forever, daemon=True).start()
    calls = []
    decode = port_srv.state.batcher.decode_fn
    port_srv.state.batcher.decode_fn = lambda p, lens, new: calls.append(p.shape) or decode(
        p, lens, new)
    try:
        port = _post_many(port_srv.server_address[1], WINDOW_ROWS, 5)
        ref = _post_many(ref_srv.server_address[1], WINDOW_ROWS, 5)
    finally:
        for srv in (port_srv, ref_srv):
            srv.shutdown()
            srv.server_close()
        ref_srv.state.batcher.stop()
    assert [code for code, _, _ in port] == [200] * 6
    assert [chain for _, chain, _ in port] == [chain for _, chain, _ in ref]
    assert [chain for _, chain, _ in port] == [_inline(model, row, 5) for row in WINDOW_ROWS]
    assert all(shape[0] in (1, 2, 4, 8) and shape[1] % 16 == 0 for shape in calls)


def test_qos_server_sheds_the_noisy_tenant_and_serves_the_debug_routes(tiny):
    """A continuous server with quotas, alerts, a 0.2 s history cadence and
    the debug endpoints: the noisy tenant's burst is refused with 429 and
    Retry-After, vip and the default tenant are served, the engine saw
    their priorities, and every debug route answers."""
    srv = _serve(tiny, batching="continuous", n_slots=2, block_size=8, prefill_chunk=8,
                 tenant_quotas=QUOTAS, history_interval_s=0.2, enable_debug_endpoints=True)
    port = srv.server_address[1]
    seen = []
    submit = srv.state.engine.submit
    srv.state.engine.submit = lambda *a, **kw: seen.append(kw.get("priority")) or submit(*a, **kw)
    try:
        noisy = _post_many(port, [[1, 2, 3]] * 4, 8, tenant="noisy")
        vip = _post_many(port, [[4, 5, 6]], 4, tenant="vip")
        default = _post_many(port, [[7, 8, 9]], 4)
        time.sleep(0.5)  # a couple of history ticks
        pages = {path: _get(port, path) for path in (
            "/debug/clockz", "/debug/flightz?kind=serve&limit=5", "/debug/historyz",
            "/debug/alertz", "/debug/profilez?seconds=0.05&format=json", "/debug/trace")}
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.engine.stop()
    codes = sorted(code for code, _, _ in noisy)
    assert codes == [200, 200, 429, 429]
    assert all(int(retry) >= 1 for code, _, retry in noisy if code == 429)
    assert vip[0][:2] == (200, _inline(tiny, [4, 5, 6], 4)) and default[0][0] == 200
    assert sorted(seen) == [0, 0, 1, 2]
    assert all(status == 200 for status, _ in pages.values())
    assert json.loads(pages["/debug/clockz"][1])["pid"] == os.getpid()
    assert json.loads(pages["/debug/historyz"][1])["ticks"] >= 1
    alertz = json.loads(pages["/debug/alertz"][1])
    assert "ttft-slo[60s]" in {i["instance"] for i in alertz["instances"]}
    assert json.loads(pages["/debug/profilez?seconds=0.05&format=json"][1])["samples"] > 0
    flight = [json.loads(line)
              for line in pages["/debug/flightz?kind=serve&limit=5"][1].splitlines()]
    assert flight and all(r["kind"] == "serve" for r in flight)
    assert not srv.state.history._ticker and not srv.state.alerts._ticker


def test_metrics_health_and_trace(servers):
    """/metrics parses with the copied exposition validator and carries
    the engine's families (one capture of the step), /healthz and /readyz
    say ready, /debug/trace holds finished request spans with their
    phase marks."""
    port = servers["continuous"]
    client = DecodeClient(f"http://127.0.0.1:{port}", timeout=60)
    client.generate([[9, 8, 7]], max_new_tokens=3)
    families = validate_text(client.metrics_text())
    flat = client.metrics()
    assert flat["tf_operator_tpu_serve_engine_compiles_total"] == 1
    assert flat["tf_operator_tpu_serve_ttft_seconds_count"] >= 1
    assert "tf_operator_tpu_serve_engine_kv_pool_bytes" in families
    assert client.healthy()["status"] == "ok" and client.ready()
    trace = client.trace()
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "i"}
    assert spans and {"queued", "admitted", "first-token", "finished"} <= marks
    assert all(str(e["args"].get("corr", "")).startswith("req-") for e in spans)


# -- the decode modes: int8, inline speculation, beams, engine speculation -------


def _f32_tiny():
    """GPT_TINY in f32 from seed 0: greedy chains of the speculative paths
    are token-exact against generate at f32."""
    return torch_gpt.GPT(dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32),
                         generator=torch.Generator().manual_seed(0))


def _serve(model, **kw):
    srv = torch_server.make_server(model, device="cpu", max_new_cap=64, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def mode_servers():
    """(f32 model, {name: server}): the engine with both int8 flags and
    ngram speculation, and the inline path with --speculative and an
    int8 KV cache."""
    model = _f32_tiny()
    out = {
        "engine": _serve(model, batching="continuous", n_slots=2, block_size=8,
                         prefill_chunk=8, kv_quant_int8=True, weights_int8=True,
                         speculate="ngram", spec_depth=3),
        "inline": _serve(model, speculative=True, kv_quant_int8=True),
    }
    yield model, out
    for srv in out.values():
        srv.shutdown()
        srv.server_close()
        if srv.state.engine is not None:
            srv.state.engine.stop()


def test_int8_speculating_engine_serves_the_inline_chains(mode_servers):
    """The engine behind --kv-int8 --weights-int8 --speculate ngram: the
    server quantized the model once (the state and the engine hold the
    same int8 twin), the chains equal the inline int8 generate's, the
    verify rounds ran, and /metrics and /healthz say so."""
    model, servers = mode_servers
    srv = servers["engine"]
    twin = srv.state.model
    assert srv.state.engine.model is twin and twin is not model
    assert isinstance(twin.lm_head, torch_quant.QuantDenseGeneral)
    client = DecodeClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=60)
    rows = [[5, 6, 7] * 4, [1, 2, 3], list(range(30, 50))]
    chains = client.generate(rows, max_new_tokens=10)
    for row, chain in zip(rows, chains):
        assert chain == torch_gpt.generate(model, torch.tensor([row]), 10, kv_quant_int8=True,
                                           weights_int8=True)[0].tolist()
    events = list(client.generate_stream(rows[0], max_new_tokens=10))
    assert events[-1]["tokens"] == [chains[0]]
    flat = client.metrics()
    assert flat["tf_operator_tpu_serve_spec_rounds_total"] > 0
    assert flat["tf_operator_tpu_serve_engine_verify_compiles_total"] == 1
    health = client.healthy()
    assert health["kv_int8"] is True and health["weights_int8"] is True


def test_speculative_inline_path_and_its_fallbacks(mode_servers):
    """--speculative: a single uniform row takes generate_speculative
    (its counter moves; the chain is generate's at f32), on /generate and
    /generate_stream; multi-row, ragged and below-ngram requests fall back
    to generate (the counter stays)."""
    model, servers = mode_servers
    port = servers["inline"].server_address[1]
    client = DecodeClient(f"http://127.0.0.1:{port}", timeout=60)
    counter = "tf_operator_tpu_serve_speculative_decodes_total"

    def want(rows, new):
        return [torch_gpt.generate(model, torch.tensor([row]), new,
                                   kv_quant_int8=True)[0].tolist() for row in rows]

    before = client.metrics()[counter]
    row = [5, 6, 7] * 4
    assert client.generate([row], max_new_tokens=12) == want([row], 12)
    spec = torch_gpt.generate_speculative(model, torch.tensor([row]), 12, ngram=2,
                                          kv_quant_int8=True)
    assert want([row], 12) == spec.tolist()
    events = list(client.generate_stream(row, max_new_tokens=12))
    assert events[-1]["tokens"] == want([row], 12)
    assert client.metrics()[counter] == before + 2
    for rows in ([row, list(range(12))], [row, [1, 2, 3]], [[7]]):
        assert client.generate(rows, max_new_tokens=6) == want(rows, 6)
    assert client.metrics()[counter] == before + 2


@pytest.mark.parametrize("batching", ["continuous", "none"])
def test_beams_over_http(servers, tiny, batching):
    """num_beams 3 on a uniform batch of two, with or without the engine
    (beams always ride the inline path): "tokens" each row's best beam,
    "beams" and "beam_scores" beam_search's, best first."""
    port = servers[batching]
    rows = [[1, 2, 3, 4], [9, 8, 7, 6]]
    status, body = _post(port, "/generate", {"input_ids": rows, "max_new_tokens": 5,
                                             "num_beams": 3})
    assert status == 200, body
    seqs, scores = torch_gpt.beam_search(tiny, torch.tensor(rows), 5, num_beams=3)
    assert body["beams"] == seqs.tolist()
    assert body["tokens"] == seqs[:, 0].tolist() and body["prompt_lens"] == [4, 4]
    np.testing.assert_allclose(body["beam_scores"], scores.numpy(), rtol=1e-6)
    assert all(a >= b for row in body["beam_scores"] for a, b in zip(row, row[1:]))


@pytest.mark.parametrize("path, payload, text", [
    ("/generate", {"input_ids": [[1, 2]], "num_beams": 2, "temperature": 0.5},
     "num_beams > 1 requires greedy settings (temperature 0, no top_k/top_p)"),
    ("/generate", {"input_ids": [[1, 2]], "num_beams": 2, "top_k": 3},
     "num_beams > 1 requires greedy settings (temperature 0, no top_k/top_p)"),
    ("/generate", {"input_ids": [[1, 2]] * 22, "num_beams": 3},
     "batch 22 x num_beams 3 exceeds the device admission cap 64"),
    ("/generate", {"input_ids": [[1, 2]], "num_beams": 9}, "num_beams must be an int in [1, 8]"),
    ("/generate_stream", {"input_ids": [[1, 2]], "num_beams": 2},
     "/generate_stream does not support beams"),
])
def test_beam_requests_refused_in_the_reference_words(servers, path, payload, text):
    status, body = _post(servers["none"], path, payload)
    assert status == 400 and body["error"] == text


@pytest.mark.parametrize("option, text", [
    ({"batching": "continuous", "speculative": True},
     "batching='continuous' and speculative are mutually exclusive"),
    ({"speculate": "ngram"}, "speculate requires batching='continuous'"),
    ({"batching": "continuous", "kv_layout": "dense", "speculate": "ngram"},
     "speculate requires kv_layout='paged'"),
    ({"speculate": "medusa"}, "speculate must be 'off', 'ngram' or 'draft', got 'medusa'"),
    ({"batching": "continuous", "speculate": "draft", "draft_preset": "huge"},
     "unknown draft preset 'huge'"),
])
def test_make_server_refuses_decode_mode_combinations(tiny, option, text):
    with pytest.raises(ValueError) as err:
        torch_server.make_server(tiny, device="cpu", **option)
    assert str(err.value).startswith(text)


def test_draft_mode_needs_the_targets_vocabulary():
    """--speculate draft over a target whose vocabulary is not the draft
    presets' (GPT-small's 32000 against 512; here 1000) is refused with
    the reference engine's text; over GPT_TINY it serves the chains of
    speculate off."""
    other = torch_gpt.GPT(dataclasses.replace(torch_gpt.GPT_TINY, vocab_size=1000))
    with pytest.raises(ValueError, match=r"draft vocab 512 != target vocab 1000 \(the draft "
                                         r"must share the tokenizer\)"):
        torch_server.make_server(other, device="cpu", batching="continuous",
                                 speculate="draft")
    model = _f32_tiny()
    srv = _serve(model, batching="continuous", n_slots=2, block_size=8, speculate="draft",
                 draft_preset="draft-tiny", spec_depth=2)
    try:
        client = DecodeClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=60)
        rows = [[4, 4, 4, 4], [3, 1, 4, 1, 5]]
        assert client.generate(rows, max_new_tokens=6) == [
            torch_gpt.generate(model, torch.tensor([r]), 6)[0].tolist() for r in rows]
        assert srv.state.engine.draft.compiles == 1
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.engine.stop()


@pytest.mark.parametrize("argv, text", [
    (["--batching", "continuous", "--speculative"],
     "--batching continuous is mutually exclusive with --speculative"),
    (["--speculate", "ngram"], "--speculate requires --batching continuous"),
    (["--batching", "continuous", "--kv-layout", "dense", "--speculate", "ngram"],
     "--speculate requires --kv-layout paged"),
    (["--batching", "continuous", "--speculate", "ngram", "--spec-depth", "0"],
     "--spec-depth must be >= 1"),
    (["--draft-preset", "tiny"], "--draft-preset requires --speculate draft"),
    (["--batching", "continuous", "--speculate", "draft", "--draft-preset", "huge"],
     "unknown --draft-preset 'huge' (have: draft-tiny, tiny)"),
])
def test_cli_refuses_decode_mode_combinations(argv, text, capsys):
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(argv)
    assert err.value.code == 2 and text in capsys.readouterr().err


def test_cli_parses_the_decode_mode_flags():
    args = torch_server.parse_args([
        "--preset", "small", "--kv-int8", "--weights-int8", "--batching", "continuous",
        "--speculate", "draft", "--spec-depth", "3", "--draft-preset", "tiny"])
    assert (args.kv_int8, args.weights_int8, args.speculate, args.spec_depth,
            args.draft_preset) == (True, True, "draft", 3, "tiny")
    assert torch_server.parse_args(["--speculative"]).speculative


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_serves_and_drains_on_sigterm(tiny):
    """python -m tf_operator_tpu_torch.serve --preset tiny --device cpu
    --batching continuous as a subprocess: /healthz answers, /generate
    decodes (random weights from seed 0: the chain of the same model
    built here), and on SIGTERM it drains and exits 0, as the reference's
    main does."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve", "--preset", "tiny",
         "--device", "cpu", "--batching", "continuous", "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = _get(port, "/healthz")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body = _post(port, "/generate", {"input_ids": [[1, 2, 3]], "max_new_tokens": 4})
        assert status == 200
        assert body["tokens"] == [_inline(tiny, [1, 2, 3], 4)]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    assert "RANDOM weights" in err and "drained; exiting 0" in err


def test_cli_serves_int8_speculative_and_drains_on_sigterm(tiny):
    """The CLI with --kv-int8 --weights-int8 --speculative (inline) as a
    subprocess: a single-row request is generate_speculative's chain on
    the int8 twin of the same seeded model, a beam request answers, and
    SIGTERM drains to exit 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve", "--preset", "tiny",
         "--device", "cpu", "--kv-int8", "--weights-int8", "--speculative",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = _get(port, "/healthz")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        assert json.loads(body)["weights_int8"] is True
        row = [5, 6, 7, 5, 6, 7, 5]
        status, body = _post(port, "/generate", {"input_ids": [row], "max_new_tokens": 6})
        assert status == 200
        want = torch_gpt.generate_speculative(torch_quant.quantize_model(tiny),
                                              torch.tensor([row]), 6, ngram=2,
                                              kv_quant_int8=True)
        assert body["tokens"] == want.tolist()
        status, body = _post(port, "/generate", {"input_ids": [row], "max_new_tokens": 3,
                                                 "num_beams": 2})
        assert status == 200 and len(body["beams"][0]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "drained; exiting 0" in proc.stderr.read()


def test_cli_loads_the_port_checkpoint(tmp_path, tiny):
    """--checkpoint-dir serves the newest step the port's Checkpointer
    wrote."""
    from tf_operator_tpu_torch.train.trainer import Checkpointer

    trained = torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(5))
    Checkpointer(str(tmp_path)).write(7, {"model": trained.state_dict(), "optimizer": {}})
    model = torch_server.load_model("tiny", str(tmp_path), torch.device("cpu"))
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, trained.state_dict()[name]), name


def test_new_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {NEW_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for mod in NEW_MODULES:
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(BLOCKED), f"{path}:{node.lineno}"


@pytest.mark.cuda
def test_cuda_graphs_replay_the_eager_step():
    """On the card, GPT_TINY in bf16: each program of the paged step is
    one CUDA graph captured once, and a replay gives the eager step's next
    tokens, logits and pool bit for bit (the same kernels on the same inputs);
    an engine on the card captures each program once and serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(0),
                          device="cuda")
    n, total, bs, nb, prompt, lens, tables = _paged_case()
    graphed = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
    eager = torch_gpt.PagedSlotDecodeStep(model, n, total, bs, nb)
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    for _ in range(12):
        got = graphed(tok, index, prompt, lens, tables).cpu().numpy()
        want = eager.run_eager(tok, index, prompt, lens, tables).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(graphed.logits, eager.logits)
        tok, index = got.astype(np.int32), index + 1
    for a, b in zip(graphed.cache.keys + graphed.cache.values,
                    eager.cache.keys + eager.cache.values):
        assert torch.equal(a[1:], b[1:])
    assert graphed.compiles == 1 and graphed._step.graph is not None
    eng = torch_engine.ContinuousBatchingEngine(model, n_slots=2, block_size=8, prefill_chunk=8)
    try:
        rows = [[1, 2, 3], list(range(40)), [7] * 17]
        chains = [eng.submit(row, 5).result(120) for row in rows]
    finally:
        eng.stop()
    assert (eng.step.compiles, eng.step.prefill_compiles, eng.step.copy_compiles) == (1, 1, 1)
    for row, chain in zip(rows, chains):
        assert chain[:len(row)] == row and len(chain) == len(row) + 5


# -- the serving artifact (serve/export.py; tests/test_serve.py's
# -- TestQuantizedExport) -------------------------------------------------------


def _export_tiny(model, out, step=7):
    from tf_operator_tpu_torch.serve import export as export_mod

    state = {name: t.clone() for name, t in model.state_dict().items()}
    return export_mod.export(lambda: (state, step), str(out), "tiny")


def test_export_artifact_holds_the_quantized_bytes(weights, tmp_path):
    """The artifact's int8 tensors are byte-equal to quantize_model of the
    same weights and to gpt_int8_state_dict_from_flax of the reference's
    quantize_params (its scales within one ulp of the reference's, as
    tests/test_torch_quant.py holds them); the manifest has the
    reference's keys, and dropping the optimizer's moments plus int8
    kernels leaves well under half the f32 weights' bytes."""
    from tf_operator_tpu.ops.quant import quantize_params as ref_quantize_params

    from tf_operator_tpu_torch.models.convert import gpt_int8_state_dict_from_flax
    from tf_operator_tpu_torch.serve import export as export_mod

    _, params, model = weights
    manifest = _export_tiny(model, tmp_path / "art")
    assert set(manifest) == {"quantized", "preset", "step", "params_bytes",
                             "source_params_bytes", "tool"}
    assert (manifest["quantized"], manifest["preset"], manifest["step"]) == (True, "tiny", 7)
    assert manifest["params_bytes"] < 0.6 * manifest["source_params_bytes"]
    assert export_mod.is_exported_dir(str(tmp_path / "art"))
    assert not export_mod.is_exported_dir(str(tmp_path))
    state, loaded = export_mod.load_exported(str(tmp_path / "art"))
    assert loaded == manifest and torch_quant.is_quantized(state)
    own = torch_quant.quantize_model(model).state_dict()
    ref = gpt_int8_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, ref_quantize_params(params)))
    assert set(state) == set(own) == set(ref)
    int8 = [name for name, t in state.items() if t.dtype == torch.int8]
    # q, k, v, out, mlp_in and mlp_out a layer, and the LM head
    assert len(int8) == 6 * torch_gpt.GPT_TINY.num_layers + 1
    for name, tensor in state.items():
        assert torch.equal(tensor, own[name]), name
        if tensor.dtype == torch.int8:
            assert torch.equal(tensor, ref[name]), name
        elif name.endswith("kernel_scale"):
            np.testing.assert_array_max_ulp(tensor.numpy(), ref[name].numpy(), maxulp=1)


def test_server_on_the_artifact_serves_the_int8_chains(weights, tmp_path):
    """load_model recognises the artifact and hands make_server the int8
    twin, which switches weights_int8 on by itself; its greedy chains
    equal a server's with --weights-int8 on the f32 weights. An artifact
    of another preset is refused at load."""
    _, _, model = weights
    art = tmp_path / "art"
    _export_tiny(model, art)
    twin = torch_server.load_model("tiny", str(art), "cpu")
    assert torch_quant.is_quantized(twin)
    rows = [[5, 6, 7], list(range(30, 52))]
    chains = []
    for served, kw in ((twin, {}), (model, {"weights_int8": True})):
        srv = _serve(served, batching="continuous", n_slots=2, block_size=8,
                     prefill_chunk=8, **kw)
        try:
            assert srv.state.weights_int8
            client = DecodeClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=60)
            chains.append(client.generate(rows, max_new_tokens=6))
        finally:
            srv.shutdown()
            srv.server_close()
            srv.state.engine.stop()
    assert chains[0] == chains[1]
    assert len(chains[0][1]) == len(rows[1]) + 6
    with pytest.raises(SystemExit, match="built for --preset 'tiny' but the server was started "
                                         "with --preset 'small'"):
        torch_server.load_model("small", str(art), "cpu")


def test_export_cli_restores_the_newest_step(tiny, tmp_path):
    """`python -m tf_operator_tpu_torch.serve.export` reads the newest step
    a training CLI's Checkpointer wrote; with none it exits naming the
    directory."""
    from tf_operator_tpu_torch.serve import export as export_mod
    from tf_operator_tpu_torch.train.trainer import Checkpointer

    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    with pytest.raises(SystemExit, match="no checkpoint found in"):
        export_mod.main(["--preset", "tiny", "--checkpoint-dir", ckpt, "--out", out])
    checkpointer = Checkpointer(ckpt)
    for step in (2, 5):
        checkpointer.write(step, {"model": tiny.state_dict(), "step": step})
    assert export_mod.main(["--preset", "tiny", "--checkpoint-dir", ckpt, "--out", out]) == 0
    state, manifest = export_mod.load_exported(out)
    assert manifest["step"] == 5 and manifest["tool"] == "tf_operator_tpu_torch.serve.export"
    twin = torch_quant.quantize_model(
        torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(0)))
    assert all(torch.equal(t, twin.state_dict()[name]) for name, t in state.items())
