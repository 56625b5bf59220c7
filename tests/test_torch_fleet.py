"""The port's serving fleet (tf_operator_tpu_torch/serve/fleet.py: the
InProcessFleet kubelet under the ServeService controller, its soaks and
smokes), make_server(warm_async=True) and the client's beam and debug-page
methods, on the CPU at GPT_TINY in f32, against the JAX package.

The weights are the reference's (GPT(cfg).init(PRNGKey(seed))) carried
across with models/convert.py. Criteria: every chain the fleet serves is
bit-identical to the port's inline generate (the reference's own soak
criterion), and those chains equal the reference's generate on the same
weights and prompts; the rolling update's v1 and v2 chains likewise; the
disaggregated, KV-observatory, trace, alert and autoscale smokes pass their
own checks (the trace smoke's merged timeline with all 8 hops). On the CPU
a program of a replica's engine runs eagerly; on a card each is a CUDA
graph, which chip_smoke.py's `fleet` group holds (capture under load,
rebinding swap control, memory across kills).
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.serve import fleet as torch_fleet
from tf_operator_tpu_torch.serve.client import DecodeClient
from tf_operator_tpu_torch.serve.server import make_server

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.serve import server as jax_server
except ImportError:  # a card machine without JAX
    jax = None

TCFG = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)


def _reference(seed):
    """(reference f32 cfg, the reference's params from PRNGKey(seed), the
    port state dict of them)."""
    if jax is None:
        pytest.skip("JAX is not installed")
    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.array, params["params"])
    return jcfg, params, gpt_state_dict_from_flax(params)


@pytest.fixture(scope="module")
def v1():
    return _reference(0)


@pytest.fixture(scope="module")
def v2():
    return _reference(1)


def reference_chain(jcfg, params, prompt, new):
    out = jax_gpt.generate(jcfg, params, jnp.asarray([prompt], jnp.int32), new)
    return np.asarray(out)[0].tolist()


def test_failover_soak_seed0_matches_the_reference(v1):
    """The reference's soak (3 replicas of 2 slots, 6 streams, a 137 kill
    after the first token, 2 connection resets): no stream lost, every
    failover flight-recorded, every chain the inline one; the inline
    chains equal the reference's generate."""
    jcfg, params, state = v1
    summary = torch_fleet.run_failover_soak(seed=0, cfg=TCFG, params=state, device="cpu")
    assert summary["ok"]
    assert summary["kills"] == 1
    assert summary["failovers"] >= 1
    assert summary["recorded_failovers"] >= summary["failovers"]
    assert summary["boots"] == 4  # 3, then the killed replica's replacement
    assert summary["streams"] == 6
    assert summary["chains"] == [summary["expected"][i] for i in summary["chain_prompt"]]
    for prompt, chain in zip(summary["prompts"], summary["expected"]):
        assert chain == reference_chain(jcfg, params, prompt, 12)
    # every replica's engine ran each program once, the replacement too
    assert len(summary["captures"]) == 4
    assert all(c["step"] == 1 for c in summary["captures"])


def test_failover_soak_sustained_boots_the_replacement_under_load(v1):
    """sustain=True: the client threads keep streaming until the
    replacement is ready, so it is built while the survivors serve."""
    _, _, state = v1
    summary = torch_fleet.run_failover_soak(seed=0, replicas=2, streams=4, max_new=8,
                                            cfg=TCFG, params=state, device="cpu",
                                            sustain=True)
    assert summary["ok"]
    assert summary["streams"] >= 4
    assert summary["boots"] == 3
    assert summary["boot_log"][-1]["streams_in_flight"] >= 1
    assert summary["chains"] == [summary["expected"][i] for i in summary["chain_prompt"]]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_failover_soak_multi_seed(v1, seed):
    jcfg, params, state = v1
    summary = torch_fleet.run_failover_soak(
        seed=seed, replicas=3, streams=6, kills=2, max_new=12, conn_faults=2,
        namespace=f"soak-{seed}", cfg=TCFG, params=state, device="cpu",
    )
    assert summary["ok"], torch_fleet._short(summary)
    for prompt, chain in zip(summary["prompts"], summary["expected"]):
        assert chain == reference_chain(jcfg, params, prompt, 12)


def test_rolling_update_chains_by_version_match_the_reference(v1, v2):
    """v1 -> v2 with maxUnavailable 1 under load: each stream carries the
    chain of the version it was admitted under, each version's chains
    are the reference's generate on that version's weights, no replica
    recaptures."""
    jcfg, params1, state1 = v1
    _, params2, state2 = v2
    summary = torch_fleet.run_rolling_update(
        seed=0, cfg=TCFG, params=state1, params2=state2, device="cpu",
    )
    assert summary["ok"], summary
    assert summary["by_version"]["v1"] >= 1 and summary["by_version"]["v2"] >= 1
    assert sorted(summary["compiles"].values()) == [1, 1, 1]
    assert all(summary["v1_differs_from_v2"])
    rng_prompts = _update_prompts(0, 3)
    for prompt in rng_prompts:
        for params, state in ((params1, state1), (params2, state2)):
            got = torch_fleet.inline_chains(TCFG, state, [prompt], 8, torch.device("cpu"))[0]
            assert got == reference_chain(jcfg, params, prompt, 8)


def _update_prompts(seed, n):
    """run_rolling_update's prompts for `seed` (its first rng draws)."""
    import random

    rng = random.Random(seed)
    return [[rng.randrange(1, TCFG.vocab_size) for _ in range(rng.randint(2, 5))]
            for _ in range(n)]


def test_update_weights_moves_the_beam_path_too(v1, v2):
    """After the controller's hook swaps a replica to v2, /generate with
    num_beams (the server's path outside the engine) returns v2's beams:
    the engine's module is the one the beam path decodes with."""
    from tf_operator_tpu_torch.api.types import ServeService, ServeServiceSpec
    from tf_operator_tpu_torch.controller import ServeServiceController
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    _, _, state1 = v1
    _, _, state2 = v2
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = torch_fleet.InProcessFleet(substrate, router, TCFG, {"v1": state1, "v2": state2},
                                       namespace="beam", device="cpu")
    controller = ServeServiceController(substrate, namespace="beam",
                                        weight_update=fleet.update_weights)
    svc = ServeService(spec=ServeServiceSpec(replicas=1, weights_version="v1"))
    svc.metadata.name = "beam"
    svc.metadata.namespace = "beam"
    prompt = [[5, 11, 7, 3]]
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(1)
        client = router.clients()[fleet.replica_names()[0]]
        before = client.beam_search(prompt, 6, num_beams=3)
        fresh = substrate.get_serve_service("beam", "beam")
        fresh.spec.weights_version = "v2"
        substrate.update_serve_service(fresh)
        controller.run_until_quiet()
        assert substrate.get_serve_service("beam", "beam").status.updated_replicas == 1
        after = client.beam_search(prompt, 6, num_beams=3)
    finally:
        fleet.stop()
        controller.stop()
    want = {}
    for name, state in (("v1", state1), ("v2", state2)):
        model = torch_fleet.replica_model(TCFG, state, torch.device("cpu"))
        seqs, scores = torch_gpt.beam_search(model, torch.tensor(prompt), 6, num_beams=3)
        want[name] = seqs.tolist()
    beams_before, beams_after = before[0], after[0]
    assert beams_before == want["v1"]
    assert beams_after == want["v2"]
    assert want["v1"] != want["v2"]


def test_replicas_hold_their_own_weights(v1):
    """Every replica builds its own module from the version's state dict:
    no two replicas (nor the caller's state dict) share a tensor."""
    from tf_operator_tpu_torch.api.types import ServeService, ServeServiceSpec
    from tf_operator_tpu_torch.controller import ServeServiceController
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    _, _, state = v1
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = torch_fleet.InProcessFleet(substrate, router, TCFG, {"v1": state},
                                       namespace="own", device="cpu")
    controller = ServeServiceController(substrate, namespace="own")
    svc = ServeService(spec=ServeServiceSpec(replicas=2, weights_version="v1"))
    svc.metadata.name = "own"
    svc.metadata.namespace = "own"
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)
        models = [engine.model for engine in fleet.engines().values()]
    finally:
        fleet.stop()
        controller.stop()
    pointers = [{t.data_ptr() for t in m.state_dict().values()} for m in models]
    pointers.append({t.data_ptr() for t in state.values()})
    assert not pointers[0] & pointers[1]
    assert not (pointers[0] | pointers[1]) & pointers[2]


def test_fleet_passes_the_mesh_refusal_on():
    """A ServeService with a meshShape: the port's server refuses a mesh
    (sharded decode, ROADMAP queue 1 item 6), and sync() raises it."""
    from tf_operator_tpu_torch.api.types import ServeService, ServeServiceSpec
    from tf_operator_tpu_torch.controller import ServeServiceController
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    substrate = InMemorySubstrate()
    router = LeastLoadedRouter()
    fleet = torch_fleet.InProcessFleet(
        substrate, router, TCFG, {"v1": torch_fleet.seeded_params(TCFG)}, namespace="mesh",
        mesh_shape="1x2", device="cpu",
    )
    controller = ServeServiceController(substrate, namespace="mesh")
    svc = ServeService(spec=ServeServiceSpec(replicas=1, weights_version="v1", mesh_shape="1x2"))
    svc.metadata.name = "mesh"
    svc.metadata.namespace = "mesh"
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
            fleet.sync()
    finally:
        fleet.stop()
        controller.stop()


def test_fleet_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_fleet.InProcessFleet(InMemorySubstrate(), LeastLoadedRouter(), TCFG, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_fleet.run_failover_soak(cfg=TCFG)


# -- warm_async -------------------------------------------------------------


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_warm_async_answers_warming_then_ready(monkeypatch):
    """The listener answers while the engine is built: /readyz 503
    "warming" (and /healthz 200 "warming", POSTs 503) until the engine has
    captured its programs, then 200; server_close joins the warm-up."""
    from tf_operator_tpu_torch.serve import engine as engine_mod

    gate = threading.Event()
    warm_up = engine_mod.ContinuousBatchingEngine._warm_up

    def held_warm_up(self):
        gate.wait(30)
        warm_up(self)

    monkeypatch.setattr(engine_mod.ContinuousBatchingEngine, "_warm_up", held_warm_up)
    model = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(0))
    server = make_server(model, batching="continuous", n_slots=2, warm_async=True,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _get(base, "/readyz") == (503, {"status": "warming", "model": "gpt"})
        status, health = _get(base, "/healthz")
        assert (status, health["status"]) == (200, "warming")
        client = DecodeClient(base, timeout=10)
        assert client.ready() is False
        assert server.state.engine is None and server.state.ready_at is None
        gate.set()
        deadline = time.monotonic() + 60
        while not client.ready():
            assert time.monotonic() < deadline, "never became ready"
            time.sleep(0.02)
        assert _get(base, "/readyz")[0] == 200
        assert client.generate([[1, 2, 3]], 4)[0][:3] == [1, 2, 3]
        assert server.state.engine.step.compiles == 1
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        if server.state.engine is not None:
            server.state.engine.stop()
    assert not server.state.warmup_thread.is_alive()


def test_warm_async_failure_shows_on_readyz(monkeypatch):
    from tf_operator_tpu_torch.serve import engine as engine_mod

    def broken(self):
        raise RuntimeError("planted warm-up failure")

    monkeypatch.setattr(engine_mod.ContinuousBatchingEngine, "_warm_up", broken)
    model = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(0))
    server = make_server(model, batching="continuous", n_slots=2, warm_async=True,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        server.state.warmup_thread.join(30)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert _get(base, "/readyz") == (503, {"status": "failed", "model": "gpt"})
    finally:
        server.shutdown()
        server.server_close()


def test_warm_async_needs_continuous_batching_as_the_reference(v1):
    jcfg, params, _ = v1
    model = torch_gpt.GPT(TCFG, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as port_err:
        make_server(model, batching="none", warm_async=True, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        jax_server.make_server(jcfg, params, batching="none", warm_async=True)
    assert str(port_err.value) == str(ref_err.value)


# -- the client's pages -----------------------------------------------------


def test_client_beam_and_debug_pages(v1):
    """beam_search against the port's beam_search; clockz, flightz (with
    its request filter), historyz, alertz and profilez parsed from a
    running server."""
    _, _, state = v1
    model = torch_fleet.replica_model(TCFG, state, torch.device("cpu"))
    server = make_server(model, batching="continuous", n_slots=2, device="cpu",
                         enable_debug_endpoints=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = DecodeClient(f"http://127.0.0.1:{server.server_address[1]}", timeout=30)
    try:
        beams, scores = client.beam_search([[3, 1, 4, 1]], 5, num_beams=2)
        seqs, want_scores = torch_gpt.beam_search(model, torch.tensor([[3, 1, 4, 1]]), 5,
                                                  num_beams=2)
        assert beams == seqs.tolist()
        np.testing.assert_allclose(scores, want_scores.tolist(), rtol=1e-6)
        clock = client.clockz()
        assert set(clock) == {"mono", "perf", "wall", "tracer_epoch_perf", "pid"}
        events = list(client.generate_stream([5, 6, 7], 3))
        corr = events[-1]["request_id"]
        records = client.flightz(request=corr)
        assert records and all(r["corr"] == corr for r in records)
        assert {r["fields"]["op"] for r in records} >= {"submit", "admit"}
        assert client.flightz(kind="serve", limit=2)[-1]["kind"] == "serve"
        server.state.history.tick()
        history = client.historyz(series="tf_operator_tpu_serve_decodes_total", points=True)
        assert "series" in history
        alerts = client.alertz()
        assert {"rules", "instances", "firing"} <= set(alerts)
        assert client.alertz(firing=True)["instances"] == []
        profile = client.profilez(seconds=0.2, hz=50)
        assert "samples" in profile or "stacks" in profile or "duty_cycle" in profile
    finally:
        server.shutdown()
        server.server_close()
        server.state.engine.stop()


# -- the smokes -------------------------------------------------------------


def test_disagg_smoke_matches_the_reference(v1):
    jcfg, params, state = v1
    summary = torch_fleet.run_disagg_smoke(seed=0, cfg=TCFG, params=state, device="cpu")
    assert summary["ok"]
    assert summary["migrations"] >= 1
    import random

    rng = random.Random(0)
    shared = [rng.randrange(1, TCFG.vocab_size) for _ in range(16)]
    prompts = [shared + [rng.randrange(1, TCFG.vocab_size) for _ in range(rng.randint(1, 3))]
               for _ in range(4)]
    for prompt, chain in zip(prompts, summary["chains"]):
        assert chain == reference_chain(jcfg, params, prompt, 12)


def test_kv_observatory_smoke(v1):
    _, _, state = v1
    summary = torch_fleet.run_kv_observatory_smoke(seed=0, cfg=TCFG, params=state, device="cpu")
    assert summary["ok"], summary["problems"]
    assert summary["duplication_factor"] > 1.0
    assert summary["reprefill_waste_tokens"] > 0


def test_trace_smoke_has_all_eight_hops(v1):
    from tf_operator_tpu_torch.telemetry.collector import HOP_NAMES

    _, _, state = v1
    summary = torch_fleet.run_trace_smoke(seed=0, cfg=TCFG, params=state, device="cpu")
    assert summary["ok"], summary["problems"]
    assert summary["migrated_traces"]
    for tid in summary["migrated_traces"]:
        hops = [h["name"] for h in summary["breakdowns"][tid]["hops"]]
        assert hops == list(HOP_NAMES) and len(hops) == 8


def test_alert_smoke(v1):
    _, _, state = v1
    summary = torch_fleet.run_alert_smoke(seed=0, cfg=TCFG, params=state, device="cpu")
    assert summary["ok"], summary["problems"]
    assert summary["resolved"] and "ttft-slo[2s]" in summary["fired"]


def test_autoscale_smoke_with_the_observatory(v1):
    """The out-and-in arc (no oscillation, no stream lost or diverged,
    trace-correlated scale records) with the observatory scraped at the
    scaled-out point: two replicas in the fleet SLO, a merged trace."""
    _, _, state = v1
    summary = torch_fleet.run_autoscale_smoke(seed=0, cfg=TCFG, params=state, device="cpu",
                                              observe=True)
    assert summary["ok"], summary["problems"]
    assert summary["scale_out_records"] >= 1 and summary["scale_in_records"] >= 1
    assert summary["boots"] == 2
    observed = summary["observatory"]
    assert observed["replicas_scraped"] == 2
    assert observed["trace_hops"] == ["queue_wait", "route_decision", "decode_admit",
                                      "first_token"]


def test_fleet_cli_soak():
    """`python -m tf_operator_tpu_torch.serve.fleet --soak --seed 0
    --device cpu` in process: exit 0 and the summary printed."""
    assert torch_fleet.main(["--soak", "--seed", "0", "--device", "cpu", "--replicas", "2",
                             "--streams", "4", "--max-new", "8"]) == 0


def test_kill_frees_the_replica_at_once(v1):
    """After kill() returns, nothing holds the killed replica's engine or
    model any more (its handler threads joined, its cycles collected): on
    a card its weights, pool and graphs are free before the replacement
    boots."""
    import weakref

    from tf_operator_tpu_torch.api.types import ServeService, ServeServiceSpec
    from tf_operator_tpu_torch.controller import ServeServiceController
    from tf_operator_tpu_torch.runtime import InMemorySubstrate
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    _, _, state = v1
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = torch_fleet.InProcessFleet(substrate, router, TCFG, {"v1": state},
                                       namespace="free", device="cpu")
    controller = ServeServiceController(substrate, namespace="free")
    svc = ServeService(spec=ServeServiceSpec(replicas=2, weights_version="v1"))
    svc.metadata.name = "free"
    svc.metadata.namespace = "free"
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)
        # a stream in flight on the victim when it dies
        victim = fleet.replica_names()[0]
        engine = fleet.engines()[victim]
        refs = [weakref.ref(engine), weakref.ref(engine.model)]
        client = router.clients()[victim]
        stream = client.generate_stream([1, 2, 3], 40)
        next(iter(stream))
        del engine, client
        fleet.kill(victim)
        assert [r() for r in refs] == [None, None]
        with pytest.raises(Exception):
            list(stream)
        controller.run_until_quiet()
        assert fleet.sync() == [victim]
        fleet.wait_ready(2)
    finally:
        fleet.stop()
        controller.stop()
