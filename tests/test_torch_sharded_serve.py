"""The port's sharded decode (tf_operator_tpu_torch/models/gpt.py
ShardedPagedSlotDecodeStep, the engine's mesh_shape, make_server's
mesh_shape, the fleet's meshShape) on the CPU, over ('batch','model')
meshes whose shards share the one `cpu` device: the port's counterpart of
the reference's virtual CPU devices (parallel/mesh.py make_device_mesh
takes a device list in which a device may repeat).

Held against:
- the JAX package's single-device engine (tests/test_engine.py's
  TestShardedEngine owes that engine bit-identical chains, and is
  slow-marked there), on the same weights converted from flax, in f32 as
  tests/test_torch_serve_engine.py holds the port's unsharded engine:
  every decision's top-2 margin is checked above MIN_MARGIN, so a
  framework's ~1e-6 differences cannot flip a token;
- the port's own unsharded engine, in the model's bf16. A shard runs a
  narrower product (its heads' columns of q/k/v, its rows of mlp_in) and
  a batch shard fewer rows, which may round differently: where a sharded
  chain first differs, the unsharded logits there must have a top-2 gap
  within SHARD_MARGIN_ULPS bf16 ulps (a near-tie), as on the card.

The engines run with start=False and are driven by hand
(tests/test_torch_serve_engine.py's `drive`), on tests/test_engine.py's
TestShardedEngine job mix: a shared-prefix family (prefix cache and
copy-on-write), a near-max prompt (chunked prefill) and random fill.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_serve_engine import drive, min_margin, outcomes
from test_torch_spec_decode import reference_engine

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import sharding as torch_sharding
from tf_operator_tpu_torch.serve import engine as torch_engine
from tf_operator_tpu_torch.serve import server as torch_server
from tf_operator_tpu_torch.serve.client import DecodeClient
from torch_threads import one_torch_thread  # noqa: F401

MIN_MARGIN = 1e-4
SHARD_MARGIN_ULPS = 2
MESHES = [(1, 2), (2, 2)]
ENGINE = dict(n_slots=4, kv_layout="paged", block_size=8, prefill_chunk=8)
TCFG = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)


def cpus(shape):
    """A mesh's worth of the one CPU device."""
    return ["cpu"] * (shape[0] * shape[1])


def jobs_mix(seed: int = 11):
    """tests/test_engine.py TestShardedEngine._jobs."""
    rng = np.random.default_rng(seed)
    cfg = torch_gpt.GPT_TINY
    system = rng.integers(0, cfg.vocab_size, size=16).tolist()
    jobs = [(system, 4), (system, 4), (system + [9, 9], 4)]
    jobs.append((rng.integers(0, cfg.vocab_size, size=cfg.max_seq_len - 6).tolist(), 4))
    for _ in range(8):
        new = int(rng.integers(1, 6))
        p_len = int(rng.integers(1, 36))
        jobs.append((rng.integers(0, cfg.vocab_size, size=p_len).tolist(), new))
    return jobs


def run_family_first(engine, jobs):
    """The family head first, so its blocks are cached before its peers
    admit (as the reference's test does); -> every job's outcome."""
    head = engine.submit(*jobs[0])
    drive(engine, [head])
    rest = [engine.submit(row, new) for row, new in jobs[1:]]
    drive(engine, rest)
    return outcomes([head] + rest)


def port_engine(model, mesh_shape=None, **kw):
    opts = dict(ENGINE, **kw)
    if mesh_shape is not None:
        opts.update(mesh_shape=mesh_shape, mesh_devices=cpus(mesh_shape))
    return torch_engine.ContinuousBatchingEngine(model, start=False, device="cpu", **opts)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 bits of mantissa)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0 ** -133


def near_tie(model, want, got, prompt_len) -> bool:
    """Where `got` first leaves `want`, the unsharded step's top-2 logits
    (teacher-forced along `want`) sit within SHARD_MARGIN_ULPS ulps."""
    first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    assert first >= prompt_len, "a sharded chain changed its prompt"
    cache = torch_gpt.KVCache.zeros(model.cfg, 1, first)
    step = torch_gpt.GPTDecodeStep(model)
    for i in range(first):
        logits = step(torch.tensor([want[i]]), i, cache)
    top2 = torch.topk(logits[0].float(), 2).values.tolist()
    return top2[0] - top2[1] <= SHARD_MARGIN_ULPS * bf16_ulp(top2[0])


@pytest.fixture(scope="module")
def weights():
    """(reference f32 cfg, flax params, port f32 model) on one set of
    weights."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    model = torch_gpt.GPT(TCFG)
    model.load_state_dict(gpt_state_dict_from_flax(params))
    return jcfg, params, model


@pytest.fixture(scope="module")
def reference_chains(weights):
    """The reference's single-device engine on the mix."""
    jcfg, params, _ = weights
    ref = reference_engine(jcfg, params, start=False, **ENGINE)
    out = run_family_first(ref, jobs_mix())
    ref.stop()
    return out


@pytest.fixture(scope="module")
def bf16_model():
    return torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_engine_matches_the_reference_and_unsharded(weights, reference_chains,
                                                            mesh_shape):
    """f32: the sharded engine's chains equal the reference's single-device
    engine's and the port's unsharded engine's, every decision clear of a
    near-tie; one capture (first call) of each program; the shared prefix
    reused, the identical resubmission copied on write; the pool clean."""
    model = weights[2]
    jobs = jobs_mix()
    sharded = port_engine(model, mesh_shape)
    got = run_family_first(sharded, jobs)
    sharded.stop()
    step = sharded.step
    assert (step.compiles, step.prefill_compiles, step.copy_compiles) == (1, 1, 1)
    assert sharded.pool.hits > 0 and sharded.pool.cow_copies >= 1
    sharded.pool.check()
    assert sharded.pool.in_use() == 0
    single = port_engine(model)
    want = run_family_first(single, jobs)
    single.stop()
    assert got == reference_chains
    assert got == want
    for (row, _), chain in zip(jobs, got):
        assert min_margin(model, chain, len(row)) > MIN_MARGIN


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_bf16_chains_follow_the_unsharded_engine(bf16_model, mesh_shape):
    """bf16: each sharded chain equals the unsharded engine's, or first
    leaves it at a near-tie (SHARD_MARGIN_ULPS)."""
    jobs = jobs_mix()
    outs = []
    for shape in (mesh_shape, None):
        engine = port_engine(bf16_model, shape)
        outs.append(run_family_first(engine, jobs))
        engine.stop()
    for (row, _), got, want in zip(jobs, *outs):
        assert got == want or near_tie(bf16_model, want, got, len(row))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_step_joins_before_contracting(bf16_model, mesh_shape):
    """The gather rule: the step, the prefill chunk and the verify over a
    mesh produce the unsharded programs' logits bit for bit on the CPU
    (bf16), which holds because each model shard's products are the
    unsharded products' columns and the joined activations meet attn_out
    and mlp_out whole; summing per-shard partial contractions instead
    reorders the reduction and moves them."""
    n, total, block = 4, 128, 16
    steps = {shape: (torch_gpt.ShardedPagedSlotDecodeStep(
                bf16_model, n, total, block, 40, torch_mesh.make_device_mesh(
                    shape, devices=cpus(shape)), spec_depth=2) if shape else
                torch_gpt.PagedSlotDecodeStep(bf16_model, n, total, block, 40, spec_depth=2))
             for shape in (mesh_shape, None)}
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, torch_gpt.GPT_TINY.vocab_size, (n, total), generator=gen)
    tables = torch.zeros((n, total // block), dtype=torch.long)
    tables[:, :3] = 1 + torch.arange(3 * n).reshape(n, 3)
    lens = torch.tensor([5, 9, 3, 12])
    for step in steps.values():
        step.prefill(prompt[:1, :8], 0, tables[0])
    tok, index = prompt[:, 0].clone(), torch.zeros(n, dtype=torch.long)
    for _ in range(12):
        nxt = {shape: step(tok, index, prompt, lens, tables) for shape, step in steps.items()}
        assert torch.equal(steps[mesh_shape].logits, steps[None].logits)
        tok, index = nxt[None], index + 1
    window = torch.stack([tok] * 3, 1)
    for step in steps.values():
        step.verify(window, index, prompt, lens, tables)
    assert torch.equal(steps[mesh_shape].verify_logits, steps[None].verify_logits)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2"])
def test_kv_pool_shards_one_over_n(bf16_model, mesh_shape):
    """A model shard's pool is exactly the pool's bytes over the model
    shards, and the gauges show the mesh that formed; the unsharded engine
    reports 1 device and a shard of the whole pool."""
    engine = port_engine(bf16_model, mesh_shape)
    batch, model_axis = mesh_shape
    step = engine.step
    assert step.kv_bytes_per_shard * model_axis == step.kv_bytes_total
    assert len(step.shard_pools) == model_axis
    assert all(len(copies) == 1 for copies in step.shard_pools)  # one device holds them
    heads = {pool.keys[0].shape[2] for copies in step.shard_pools for pool in copies}
    assert heads == {torch_gpt.GPT_TINY.num_heads // model_axis}
    flat = {name: value for (name, _), value in engine.metrics().items()}
    assert flat["engine_mesh_devices"] == batch * model_axis
    assert flat["engine_mesh_model_shards"] == model_axis
    assert flat["engine_kv_shard_bytes"] * model_axis == flat["engine_kv_pool_bytes"]
    single = port_engine(bf16_model)
    flat1 = {name: value for (name, _), value in single.metrics().items()}
    assert flat1["engine_mesh_devices"] == flat1["engine_mesh_model_shards"] == 1
    assert flat1["engine_kv_shard_bytes"] == flat1["engine_kv_pool_bytes"]
    assert flat1["engine_kv_pool_bytes"] == flat["engine_kv_pool_bytes"]
    for eng in (engine, single):
        eng.stop()


@pytest.mark.parametrize("option, shape, error, match", [
    ({"kv_layout": "dense"}, (1, 2), ValueError, "mesh_shape requires kv_layout='paged'"),
    ({"weights_int8": True}, (1, 2), ValueError,
     "weights_int8 is not supported on the sharded decode step"),
    ({"n_slots": 3}, (2, 2), ValueError, "n_slots 3 must divide over 2 'batch' shards"),
    ({}, (1, 4), ValueError, "num_heads 2 must divide over 4 'model' shards"),
    ({}, "1x", ValueError, "mesh_shape must be 'BATCHxMODEL'"),
], ids=["dense", "weights_int8", "slots", "heads", "malformed"])
def test_sharded_engine_refusals(bf16_model, option, shape, error, match):
    """The reference's refusals, in its words."""
    devices = ["cpu"] * 4
    with pytest.raises(error, match=match):
        torch_engine.ContinuousBatchingEngine(
            bf16_model, start=False, device="cpu", mesh_shape=shape, mesh_devices=devices,
            **dict(ENGINE, **option))


def test_the_step_checks_its_mesh(bf16_model):
    """The step itself: a mesh without ('batch','model') axes, and the
    sharded class without a mesh, are refused."""
    other = torch_mesh.make_device_mesh((1, 2), ("data", "tensor"), devices=cpus((1, 2)))
    with pytest.raises(ValueError, match="needs a \\('batch','model'\\) mesh"):
        torch_gpt.PagedSlotDecodeStep(bf16_model, 2, 32, 8, 9, mesh=other)
    with pytest.raises(ValueError, match="requires a mesh"):
        torch_gpt.ShardedPagedSlotDecodeStep(bf16_model, 2, 32, 8, 9, None)


def test_device_mesh_repeats_and_collapses():
    """make_device_mesh: a listed device may repeat; the default list is
    every device of the type (one CPU), onto which a bigger shape
    collapses as the reference's rule says, (len(devices), 1)."""
    mesh = torch_mesh.make_device_mesh((2, 2), devices=cpus((2, 2)))
    assert mesh.shape == {"batch": 2, "model": 2} and mesh.size == 4
    assert {dev for row in mesh.devices for dev in row} == {torch.device("cpu")}
    collapsed = torch_mesh.make_device_mesh((2, 2), device="cpu")
    assert collapsed.shape == {"batch": 1, "model": 1}
    more = torch_mesh.make_device_mesh((1, 2), devices=cpus((2, 2)))
    assert more.shape == {"batch": 1, "model": 2}
    assert torch_mesh.short_host_devices("cpu", 4) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="axes must be >= 1"):
        torch_mesh.make_device_mesh((0, 2), devices=cpus((1, 2)))


def test_serve_rules_split_only_output_dims(bf16_model):
    """SERVE_DECODE_RULES: the shards of q/k/v are their heads' columns
    and of mlp_in its output rows, as views of the model's tensors;
    attn_out, mlp_out, the embeddings and the head are untouched."""
    params = dict(bf16_model.named_parameters())
    halves = [torch_sharding.model_shard(params, torch_sharding.SERVE_DECODE_RULES, m, 2)
              for m in range(2)]
    kernel = params["layer_0.attention.query.kernel"]
    assert torch.equal(torch.cat([h["layer_0.attention.query.kernel"] for h in halves], 1),
                       kernel)
    assert halves[1]["layer_0.attention.query.kernel"].data_ptr() != kernel.data_ptr()
    assert halves[1]["layer_0.attention.query.kernel"].untyped_storage().data_ptr() == \
        kernel.untyped_storage().data_ptr()
    assert torch.equal(torch.cat([h["layer_0.mlp_in.weight"] for h in halves], 0),
                       params["layer_0.mlp_in.weight"])
    for name in ("layer_0.attention.attn_out.kernel", "layer_0.mlp_out.weight",
                 "token_embed.weight", "lm_head.weight"):
        assert halves[1][name] is params[name]


def test_sharded_int8_kv_matches_unsharded(weights):
    """int8 KV on a 1x2 mesh: each shard quantizes its heads' vectors, the
    bytes and chains of the unsharded pool (the reference's
    test_sharded_int8_kv_matches_single_device's jobs)."""
    jobs = [(list(range(1, 12)), 5), ([9, 4, 2], 6), (list(range(20, 44)), 4)]
    chains = {}
    for shape in (None, (1, 2)):
        engine = port_engine(weights[2], shape, n_slots=2, kv_quant_int8=True,
                             prefill_chunk=6)
        handles = [engine.submit(row, new) for row, new in jobs]
        drive(engine, handles)
        chains[shape] = outcomes(handles)
        engine.stop()
    assert chains[(1, 2)] == chains[None]
    assert all(isinstance(chain, list) for chain in chains[None])


def test_sharded_ngram_speculation_matches_the_plain_engine(weights):
    """speculate="ngram" at spec_depth 4 on a 1x2 mesh: the verify program
    captured once, rounds run, and every chain the non-speculative
    unsharded engine's."""
    jobs = jobs_mix()
    engine = port_engine(weights[2], (1, 2), speculate="ngram", spec_depth=4)
    got = run_family_first(engine, jobs)
    engine.stop()
    assert engine.step.verify_compiles == 1 and engine.spec_rounds > 0
    plain = port_engine(weights[2])
    want = run_family_first(plain, jobs)
    plain.stop()
    assert got == want


def test_sharded_draft_speculation_matches_the_plain_engine(weights):
    """speculate="draft" on a 1x2 mesh: the draft model's step runs
    replicated (SlotDecodeStep(mesh=), on the mesh's first device), each
    program captured once, and every chain the non-speculative unsharded
    engine's (random draft weights: acceptance is low, chains exact)."""
    draft = torch_gpt.GPT(dataclasses.replace(torch_gpt.GPT_DRAFT, dtype=torch.float32),
                          generator=torch.Generator().manual_seed(1))
    jobs = jobs_mix()[4:]
    engine = port_engine(weights[2], (1, 2), speculate="draft", spec_depth=3,
                         draft_model=draft)
    handles = [engine.submit(row, new) for row, new in jobs]
    drive(engine, handles)
    got = outcomes(handles)
    engine.stop()
    assert engine.draft.mesh is engine.mesh
    assert (engine.step.verify_compiles, engine.draft.compiles) == (1, 1)
    plain = port_engine(weights[2])
    handles = [plain.submit(row, new) for row, new in jobs]
    drive(plain, handles)
    assert got == outcomes(handles)
    plain.stop()


def test_block_sets_cross_between_sharded_and_unsharded(weights):
    """A block set exported by the sharded engine holds the unsharded
    engine's bytes (every shard's heads joined in shard order), and each
    engine imports the other's: the follow-up request skips its prefill
    and decodes the same chain."""
    model = weights[2]
    prompt = jobs_mix()[0][0] + [3, 1, 4]
    engines = {"sharded": port_engine(model, (1, 2)), "single": port_engine(model)}
    payloads, chains = {}, {}
    for name, engine in engines.items():
        first = engine.submit(prompt, 4)
        drive(engine, [first])
        chains[name] = first.result(1)
        # start=False: the op runs inline, between quanta
        payloads[name] = json.loads(json.dumps(engine.export_prefix_blocks(prompt)))
    assert payloads["sharded"] == payloads["single"]
    assert payloads["sharded"]["blocks"] == len(prompt) // ENGINE["block_size"]
    assert chains["sharded"] == chains["single"]
    for source, target in (("single", "sharded"), ("sharded", "single")):
        fresh = port_engine(model, (1, 2) if target == "sharded" else None)
        assert fresh.import_prefix_blocks(payloads[source]) == payloads[source]["blocks"]
        req = fresh.submit(prompt, 4)
        drive(fresh, [req])
        assert req.result(1) == chains[source]
        assert fresh.pool.hits == payloads[source]["blocks"]
        fresh.stop()
    for engine in engines.values():
        engine.stop()


def test_swap_params_lays_the_new_version_out(weights):
    """swap_params on a sharded engine: the new weights reach every
    shard, and the chains are an unsharded engine's on those weights."""
    model = torch_gpt.GPT(TCFG)
    model.load_state_dict(weights[2].state_dict())
    other = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(9))
    jobs = jobs_mix()[4:8]
    engine = port_engine(model, (2, 2))
    engine.drain()
    engine.swap_params(other.state_dict())
    engine.resume_admission()
    handles = [engine.submit(row, new) for row, new in jobs]
    drive(engine, handles)
    got = outcomes(handles)
    engine.stop()
    single = port_engine(other)
    handles = [single.submit(row, new) for row, new in jobs]
    drive(single, handles)
    assert got == outcomes(handles)
    single.stop()


def test_make_server_serves_a_mesh_shape_over_http(weights):
    """make_server(mesh_shape=) boots the sharded engine; DecodeClient's
    chains over HTTP are the inline generate's; the gauges say 1x2."""
    import threading

    model = weights[2]
    srv = torch_server.make_server(model, device="cpu", batching="continuous", n_slots=2,
                                   block_size=8, prefill_chunk=8, mesh_shape=(1, 2),
                                   mesh_devices=cpus((1, 2)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = DecodeClient(f"http://127.0.0.1:{srv.server_address[1]}")
        rows = [[5, 11, 7, 3], [1, 2, 3, 4]]
        got = client.generate(rows, 6)
        flat = {name: value for (name, _), value in srv.state.engine.metrics().items()}
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.engine.stop()
    want = [torch_gpt.generate(model, torch.tensor([row]), 6)[0].tolist() for row in rows]
    assert got == want
    assert flat["engine_mesh_devices"] == 2 and flat["engine_mesh_model_shards"] == 2


def test_fleet_boots_mesh_shape_replicas(weights):
    """A ServeService with meshShape 1x2: the fleet's replica runs the
    sharded engine and serves the inline generate's chains."""
    from tf_operator_tpu_torch.api.types import ServeService, ServeServiceSpec
    from tf_operator_tpu_torch.controller import ServeServiceController
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve import fleet as torch_fleet
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    state = weights[2].state_dict()
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = torch_fleet.InProcessFleet(substrate, router, TCFG, {"v1": state}, namespace="mesh",
                                       mesh_shape="1x2", device="cpu", mesh_devices=cpus((1, 2)))
    controller = ServeServiceController(substrate, namespace="mesh")
    svc = ServeService(spec=ServeServiceSpec(replicas=1, weights_version="v1", mesh_shape="1x2"))
    svc.metadata.name = "mesh"
    svc.metadata.namespace = "mesh"
    rows = [[5, 11, 7, 3]]
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(1)
        name = fleet.replica_names()[0]
        got = router.clients()[name].generate(rows, 6)
        engine = fleet._replicas[name].server.state.engine
        flat = {key: value for (key, _), value in engine.metrics().items()}
    finally:
        fleet.stop()
        controller.stop()
    model = torch_fleet.replica_model(TCFG, state, torch.device("cpu"))
    assert got == [torch_gpt.generate(model, torch.tensor(rows), 6)[0].tolist()]
    assert flat["engine_mesh_devices"] == 2 and flat["engine_mesh_model_shards"] == 2


def test_engine_smoke_runs_on_a_mesh(capsys):
    """The engine smoke's --mesh on the CPU: the mesh forms as asked
    (several shards on the one device) and every chain is generate's."""
    assert torch_engine.main(["--smoke", "--layout", "paged", "--device", "cpu", "--mesh",
                              "2x2", "--requests", "6"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["mesh_devices"] == 4 and report["model_shards"] == 2
    assert report["kv_shard_bytes"] * 2 == report["kv_pool_bytes"]
