"""Disaggregated serving over HTTP in the port: the decode server's
migration routes (/prefill with migrate_to, /kv/export, /kv/import,
/kv/digest, /kv/statz, the role on /healthz; serve/server.py), the
client's calls for them (serve/client.py) and the prefix-aware
LeastLoadedRouter (serve/router.py) over two or three port servers in
threads, on the CPU at GPT_TINY in f32.

Every chain is held against the port's inline generate (the engine's
chains equal it: tests/test_torch_serve_engine.py), so a migrated stream,
a degraded one and a failed-over one must each give the chain of a
monolithic request. The router is held against the reference's
LeastLoadedRouter on the same inputs: each scenario runs once behind the
port's router and once behind the reference's (over fresh port servers,
or over the same scripted stub replicas as tests/test_serve_fleet.py's),
and the streams' events, the picks and pools with their prefix overlaps,
the migration, failure and failover counts, the replicas' call counts and
the router's flight ops must be equal. Its placement arithmetic
(Replica.overlap, score, score_components) is held against the
reference's Replica on the same digests and loads. Servers bind port 0 and
are closed in `finally`; nothing waits on a fixed sleep.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from typing import NamedTuple

import pytest
import torch

try:
    from tf_operator_tpu.serve import router as jax_router
    from tf_operator_tpu.serve.client import DecodeError as JaxDecodeError
    from tf_operator_tpu.telemetry.flight import FlightRecorder as JaxFlightRecorder
except ImportError:  # a card machine without JAX
    jax_router = None

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.serve import server as torch_server
from tf_operator_tpu_torch.serve.client import DecodeClient, DecodeError
from tf_operator_tpu_torch.serve.prefix import block_prefix_hashes
from tf_operator_tpu_torch.serve import router as torch_router
from tf_operator_tpu_torch.serve.router import Replica
from tf_operator_tpu_torch.telemetry.flight import FlightRecorder, default_flight

BS = 8
SHARED = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]  # two blocks


class Side(NamedTuple):
    """One router implementation: its module, the DecodeError its
    failover tells apart, and its FlightRecorder."""

    router: object
    error: type
    flight: type


SIDES = {"port": Side(torch_router, DecodeError, FlightRecorder)}
if jax_router is not None:
    SIDES["ref"] = Side(jax_router, JaxDecodeError, JaxFlightRecorder)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    return torch_gpt.GPT(cfg, generator=torch.Generator().manual_seed(3))


def inline(model, row, new):
    return torch_gpt.generate(model, torch.tensor([row]), new)[0].tolist()


class Fleet:
    """Port servers in threads, by name: start(), url(), kill(), close()."""

    def __init__(self, model):
        self.model = model
        self.servers = {}

    def start(self, name, role="", **kw):
        opts = dict(batching="continuous", n_slots=2, block_size=BS, prefill_chunk=BS,
                    max_new_cap=64, device="cpu", role=role)
        srv = torch_server.make_server(self.model, **{**opts, **kw})
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self.servers[name] = srv
        return srv

    def url(self, name):
        return f"http://127.0.0.1:{self.servers[name].server_address[1]}"

    def engine(self, name):
        return self.servers[name].state.engine

    def kill(self, name):
        """An in-process replica death: every live connection reset,
        the listener and the engine stopped."""
        srv = self.servers.pop(name)
        srv.abort_connections()
        srv.shutdown()
        if srv.state.engine is not None:
            srv.state.engine.stop()
        srv.server_close()

    def close(self):
        for name in list(self.servers):
            self.kill(name)


@pytest.fixture()
def fleet(model):
    out = Fleet(model)
    try:
        yield out
    finally:
        out.close()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


# -- the server's migration routes ----------------------------------------------


def test_role_on_healthz_digest_and_statz(fleet):
    fleet.start("p", role="prefill")
    fleet.start("m")
    client = DecodeClient(fleet.url("p"), timeout=60)
    assert client.healthy()["role"] == "prefill"
    assert DecodeClient(fleet.url("m"), timeout=60).healthy()["role"] == ""
    assert client.kv_digest() == {"role": "prefill", "block_size": BS, "digest": []}
    page = client.kv_statz(top=3)
    assert (page["role"], page["paged"], page["block_size"]) == ("prefill", True, BS)
    assert _get(fleet.url("p"), "/kv/statz?top=x") == (400, {"error": "?top= must be an integer"})


def test_prefill_export_and_import_over_http(fleet, model):
    """/prefill on one server (no migrate_to: the blocks stay there),
    /kv/export of its block set, /kv/import into another: the second
    server's digest gains the prompt's block hashes, and its chain for the
    prompt equals the inline generate with no prefill chunk run there."""
    fleet.start("a")
    fleet.start("b", role="decode")
    a = DecodeClient(fleet.url("a"), timeout=60)
    b = DecodeClient(fleet.url("b"), timeout=60)
    prompt = SHARED + [5, 6, 7]
    report = a.prefill(prompt)
    assert {k: report[k] for k in ("blocks", "migrated", "imported")} == \
        {"blocks": 2, "migrated": False, "imported": 0}
    exported = a.kv_export(prompt)
    assert exported["blocks"] == 2 and exported["payload"]["tokens"] == SHARED
    assert b.kv_import(exported["payload"])["imported"] == 2
    assert set(block_prefix_hashes(prompt, BS)) <= set(b.kv_digest()["digest"])
    assert b.generate([prompt], max_new_tokens=6) == [inline(model, prompt, 6)]
    engine = fleet.engine("b")
    assert (engine.prefill_chunks, engine.pool.hit_tokens, engine.migrations_in) == (0, 16, 1)
    assert fleet.engine("a").migrations_out == 2


def test_prefill_with_migrate_to_ships_the_block_set(fleet, model):
    fleet.start("p", role="prefill")
    fleet.start("d", role="decode")
    prompt = SHARED + list(range(30, 43))  # 29 tokens: 3 blocks
    report = DecodeClient(fleet.url("p"), timeout=60).prefill(prompt, migrate_to=fleet.url("d"))
    assert {k: report[k] for k in ("blocks", "migrated", "imported")} == \
        {"blocks": 3, "migrated": True, "imported": 3}
    assert "request_id" in report and "error" not in report
    d = DecodeClient(fleet.url("d"), timeout=60)
    events = list(d.generate_stream(prompt, max_new_tokens=5))
    assert events[-1]["tokens"] == [inline(model, prompt, 5)]
    assert fleet.engine("d").prefill_chunks == 0


def test_migration_routes_status_codes(fleet):
    """The reference's codes: 400 without a paged continuous engine (its
    text), 400 for a malformed payload or two prompt rows, and a 200 with
    "migrated": false and the error when the ship fails (the blocks stay
    cached on the prefill server)."""
    fleet.start("inline", batching="none")
    fleet.start("p", role="prefill")
    for path in ("/prefill", "/kv/export", "/kv/import"):
        status, body = _post(fleet.url("inline"), path, {"input_ids": [[1, 2]]})
        assert status == 400
        assert body["error"] == f"{path} requires --batching continuous with --kv-layout paged"
    status, body = _post(fleet.url("p"), "/kv/import", {"block_size": BS, "blocks": 1,
                                                         "tokens": [1, 2]})
    assert (status, body["error"]) == (400, "malformed KV block-set payload")
    status, body = _post(fleet.url("p"), "/prefill", {"input_ids": [[1, 2], [3, 4]]})
    assert (status, body["error"]) == (400, "/prefill takes exactly one prompt row")
    dead = fleet.start("dead")
    dead_url = fleet.url("dead")
    fleet.kill("dead")
    report = DecodeClient(fleet.url("p"), timeout=60).prefill(SHARED, migrate_to=dead_url)
    assert (report["blocks"], report["migrated"], report["imported"]) == (2, False, 0)
    assert report["error"].startswith("migrate failed: ")
    failed = [r.fields for r in default_flight().snapshot(kind="serve")
              if r.fields.get("op") == "migrate-failed"]
    assert failed and failed[-1]["target"] == dead_url
    # the blocks stay cached on the prefill server
    assert fleet.engine("p").pool.cached_blocks() == 2
    with pytest.raises(DecodeError) as err:
        DecodeClient(fleet.url("p"), timeout=60).kv_import({"block_size": 4})
    assert err.value.status == 400


# -- the router over port servers, against the reference's router ----------------


def _family():
    """Six streams sharing SHARED (two blocks) plus own tails, and two with
    no shared prefix (one block and under one block)."""
    rows = [SHARED + [40 + i] * (1 + 3 * i) for i in range(6)]
    rows += [list(range(60, 70)), [7, 8, 9]]
    return rows


def _router(side, flight, replicas, **kw):
    """side's LeastLoadedRouter over (name, url, role) replicas, its
    flight records kept apart in `flight`."""
    router = side.router.LeastLoadedRouter(retry_wait=0.01, stream_deadline=120.0,
                                           flight=flight, **kw)
    for name, url, role in replicas:
        router.add_replica(name, url, role=role)
    return router


def observed(router, flight, corrs):
    """What the two routers must agree on: the counts, every placement
    decision (what was asked, the pool, the pick, each candidate's
    prefix overlap) and the flight ops under each corr."""
    stats = router.stats()
    decisions = [
        dict({k: d[k] for k in ("role_requested", "pool", "prefix_affinity", "picked")},
             overlaps={n: c["prefix_overlap"] for n, c in d["candidates"].items()})
        for d in stats["decisions"]
    ]
    return {
        "counts": {k: stats[k] for k in ("migrations", "migrate_failures", "failovers",
                                         "reprefill_waste_tokens", "reprefill_waste_events")},
        "decisions": decisions,
        "ops": {c: [r.fields.get("op") for r in flight.snapshot(kind="serve", corr=c)]
                for c in corrs},
    }


def _events(stream):
    """A stream's events without its random trace id."""
    return [{k: v for k, v in e.items() if k != "trace_id"} for e in stream]


def on_both_routers(model, run):
    """run(fleet, side) on fresh port servers behind the port's router,
    then behind the reference's; the two observations must be equal. The
    port's is returned for the test's own checks."""
    seen = {}
    for name, side in SIDES.items():
        fleet = Fleet(model)
        try:
            seen[name] = run(fleet, side)
        finally:
            fleet.close()
    if "ref" in seen:
        assert seen["port"] == seen["ref"]
    return seen["port"]


def test_router_migrates_and_matches_the_monolithic_chains(model):
    """A prefill and a decode replica behind the router: every stream is
    picked by the decode pool; the shared-prefix family migrates once (its
    siblings then find the prefix on the decode replica's digest) and
    every chain equals the inline generate and a monolithic server's. The
    reference's router makes the same picks and migrations."""
    rows = _family()
    corrs = [f"route-family-{i}" for i in range(len(rows))]

    def run(fleet, side):
        fleet.start("p", role="prefill")
        fleet.start("d", role="decode")
        fleet.start("mono")
        flight = side.flight()
        router = _router(side, flight, [("p", fleet.url("p"), "prefill"),
                                        ("d", fleet.url("d"), "decode")])
        mono = DecodeClient(fleet.url("mono"), timeout=60)
        events = []
        for row, corr in zip(rows, corrs):
            events.append(_events(router.generate_stream(row, 6, corr=corr)))
            chain = events[-1][-1]["tokens"][0]
            assert chain == inline(model, row, 6) == mono.generate([row], max_new_tokens=6)[0]
        decode, prefill = fleet.engine("d"), fleet.engine("p")
        decode.audit_pool("test")
        assert decode.pool_audit_ok and prefill.pool_audit_ok
        return dict(observed(router, flight, corrs), events=events,
                    engines=(decode.migrations_in, prefill.migrations_out,
                             decode.prefill_chunks, prefill.prefill_chunks))

    seen = on_both_routers(model, run)
    counts = seen["counts"]
    assert counts["migrations"] >= 1 and counts["migrate_failures"] == 0
    assert counts["failovers"] == 0
    assert [d["picked"] for d in seen["decisions"]] == ["d"] * len(rows)
    assert all(d["pool"] == "role" for d in seen["decisions"])
    assert seen["engines"][:2] == (counts["migrations"], counts["migrations"])


def test_dead_prefill_replica_degrades_to_the_monolithic_path(model):
    """The prefill replica dies after the router probed it: the migration
    fails, is counted and flight-recorded, and the decode replica prefills
    for itself with the same chain, behind either router."""
    row = SHARED + [9, 9, 9]
    corr = "route-dead-prefill"

    def run(fleet, side):
        fleet.start("p", role="prefill")
        fleet.start("d", role="decode")
        flight = side.flight()
        router = _router(side, flight, [("p", fleet.url("p"), "prefill"),
                                        ("d", fleet.url("d"), "decode")])
        fleet.kill("p")
        events = _events(router.generate_stream(row, 6, corr=corr))
        assert events[-1]["tokens"] == [inline(model, row, 6)]
        return dict(observed(router, flight, [corr]), events=events,
                    chunks=fleet.engine("d").prefill_chunks)

    seen = on_both_routers(model, run)
    assert (seen["counts"]["migrations"], seen["counts"]["migrate_failures"]) == (0, 1)
    assert "migrate-failed" in seen["ops"][corr] and "route-done" in seen["ops"][corr]
    assert seen["chunks"] >= 2


def test_refused_import_degrades_to_the_monolithic_path(model):
    """The prefill replica pages in 4-token blocks, the decode replica in
    8: the decode replica refuses the shipped block set, the prefill
    replica answers "migrated": false, the router counts a failed
    migration, and the decode replica prefills for itself with the same
    chain, behind either router."""
    row = SHARED + [9, 9, 9]
    corr = "route-refused-import"

    def run(fleet, side):
        fleet.start("p", role="prefill", block_size=4, prefill_chunk=4)
        fleet.start("d", role="decode")
        flight = side.flight()
        router = _router(side, flight, [("p", fleet.url("p"), "prefill"),
                                        ("d", fleet.url("d"), "decode")])
        events = _events(router.generate_stream(row, 6, corr=corr))
        assert events[-1]["tokens"] == [inline(model, row, 6)]
        return dict(observed(router, flight, [corr]), events=events,
                    chunks=fleet.engine("d").prefill_chunks,
                    imported=fleet.engine("d").migrations_in)

    seen = on_both_routers(model, run)
    assert (seen["counts"]["migrations"], seen["counts"]["migrate_failures"]) == (0, 1)
    assert "migrate-failed" in seen["ops"][corr]
    assert (seen["imported"], seen["chunks"] >= 2) == (0, True)


def _hold_after_first_token(engine):
    """Park the engine thread after each quantum once a request has a
    token, until the returned event is set: what a replica has streamed
    when it dies is then exactly its first token."""
    release = threading.Event()
    work = engine._work_once

    def held():
        work()
        if any(req is not None and req.tokens for req in engine._reqs):
            release.wait(30)

    engine._work_once = held
    return release


def test_failover_when_a_decode_replica_is_killed_mid_stream(model):
    """Two decode replicas: the one serving a stream is killed after its
    first token (engine stopped, connections reset, listener closed). The
    stream resumes on the other with prompt + emitted tokens and completes
    with the inline chain; later streams complete there too. The
    reference's router picks, fails over and resumes the same way."""
    row = SHARED + [3, 1, 4]
    others = _family()[:3]
    corrs = ["route-kill"] + [f"route-after-kill-{i}" for i in range(len(others))]

    def run(fleet, side):
        fleet.start("d1", role="decode")
        fleet.start("d2", role="decode")
        held = {name: _hold_after_first_token(fleet.engine(name)) for name in ("d1", "d2")}
        flight = side.flight()
        router = _router(side, flight, [("d1", fleet.url("d1"), "decode"),
                                        ("d2", fleet.url("d2"), "decode")])
        stream = router.generate_stream(row, 10, corr=corrs[0])
        first = next(stream)
        dying = first["replica"]
        held["d2" if dying == "d1" else "d1"].set()
        # the dying engine leaves its loop at its next check: the kill then
        # fails its request in flight, which the client sees mid-stream
        fleet.engine(dying)._stop.set()
        held[dying].set()
        fleet.kill(dying)
        events = _events([first] + list(stream))
        assert events[-1]["tokens"] == [inline(model, row, 10)]
        assert events[-1]["failovers"] >= 1
        assert {e["replica"] for e in events if "token" in e} == {"d1", "d2"}
        later = []
        for other, corr in zip(others, corrs[1:]):
            later.append(_events(router.generate_stream(other, 4, corr=corr)))
            assert later[-1][-1]["tokens"] == [inline(model, other, 4)]
        return dict(observed(router, flight, corrs), events=events, later=later)

    seen = on_both_routers(model, run)
    assert seen["counts"]["failovers"] >= 1
    assert "failover" in seen["ops"]["route-kill"]


# -- placement arithmetic against the reference ------------------------------------


def _replica(cls, name, digest, block_size=BS, **load):
    r = cls(name, f"http://x/{name}", client=None)
    r.block_size = block_size
    r.digest = set(digest)
    for key, value in load.items():
        setattr(r, key, value)
    return r


@pytest.mark.parametrize("blocks, load, block_size", [
    (2, {}, BS),
    (0, {"inflight": 2, "queue_depth": 3.0}, BS),
    (12, {"active_slots": 4.0, "kv_occupancy": 0.5, "mean_active": 1.25}, BS),
    (3, {"inflight": 1, "mesh_devices": 4.0}, 4),
])
def test_replica_scores_equal_the_reference(blocks, load, block_size):
    """overlap, score and score_components of the port's Replica equal the
    reference's for the same digest and loads (the discount is capped)."""
    if jax_router is None:
        pytest.skip("JAX is not installed")
    row = list(range(100, 100 + 8 * 13))
    hashes = {BS: set(block_prefix_hashes(row, BS)), 4: set(block_prefix_hashes(row, 4))}
    digest = block_prefix_hashes(row, block_size)[:blocks]
    got = _replica(Replica, "r", digest, block_size, **load)
    want = _replica(jax_router.Replica, "r", digest, block_size, **load)
    assert got.overlap(hashes) == want.overlap(hashes)
    for overlap in (0, got.overlap(hashes), 100):
        assert got.score(overlap) == want.score(overlap)
        assert got.score_components(overlap) == want.score_components(overlap)
    assert got.overlap(None) == 0


# -- failover logic on scripted replicas (tests/test_serve_fleet.py) ------------


def scripted_chain(prompt, n):
    """A stand-in for greedy decoding: the continuation is a function of
    the last prompt token, so a replay of prompt + emitted on another stub
    continues the same chain."""
    out, last = [], prompt[-1]
    for _ in range(n):
        last = (last * 7 + 3) % 50
        out.append(last)
    return out


class StubReplica:
    def __init__(self, url, error):
        self.url = url
        self.error = error       # the DecodeError class of the router under test
        self.ready_flag = True
        self.queue_depth = 0.0
        self.die_after = None    # raise after yielding k tokens, once
        self.fail_status = None  # DecodeError raised at stream start
        self.calls = 0

    def ready(self):
        return self.ready_flag

    def metrics(self):
        return {"tf_operator_tpu_serve_engine_queue_depth": self.queue_depth}

    def kv_digest(self):
        return {"role": "", "block_size": 0, "digest": []}

    def generate_stream(self, input_ids, max_new_tokens=16, **kw):
        self.calls += 1
        if self.fail_status is not None:
            raise self.error(self.fail_status, "scripted failure")
        prompt = list(input_ids)
        chain = scripted_chain(prompt, max_new_tokens)
        for i, tok in enumerate(chain):
            if self.die_after is not None and i >= self.die_after:
                self.die_after = None  # die once, then recover
                raise ConnectionResetError("scripted mid-stream death")
            yield {"token": tok, "index": len(prompt) + i}
        yield {"done": True, "tokens": [prompt + chain], "prompt_lens": [len(prompt)]}


def _stub_router(side, flight, n=2):
    stubs = {}

    def factory(url):
        stubs[url] = StubReplica(url, side.error)
        return stubs[url]

    router = side.router.LeastLoadedRouter(client_factory=factory, retry_wait=0.01,
                                           flight=flight)
    for i in range(n):
        router.add_replica(f"r{i}", f"stub://r{i}")
    return router, [stubs[f"stub://r{i}"] for i in range(n)]


def _script(case, side):
    """One scripted case behind side's router: the checks of
    tests/test_serve_fleet.py, then what the two routers must agree on."""
    corr = f"route-stub-{case}"
    flight = side.flight()
    router, stubs = _stub_router(side, flight, 1 if case == "second_chance" else 2)
    out = {}
    if case == "least_loaded":
        stubs[0].queue_depth = 9.0
        router.probe()
        out["chains"] = router.generate([[3, 4]], 4, corr=corr)
        assert out["chains"] == [[3, 4] + scripted_chain([3, 4], 4)]
        assert (stubs[0].calls, stubs[1].calls) == (0, 1)
    elif case == "mid_stream":
        stubs[1].queue_depth = 9.0
        router.probe()
        stubs[0].die_after = 2
        out["events"] = _events(router.generate_stream([7, 9], 6, corr=corr))
        assert out["events"][-1]["tokens"] == [[7, 9] + scripted_chain([7, 9], 6)]
        assert out["events"][-1]["failovers"] == 1
        assert {e["replica"] for e in out["events"] if "token" in e} == {"r0", "r1"}
        ops = [r.fields.get("op") for r in flight.snapshot(kind="serve", corr=corr)]
        assert "failover" in ops and "route-done" in ops
    elif case == "status_400":
        stubs[0].fail_status = stubs[1].fail_status = 400
        with pytest.raises(side.error) as err:
            list(router.generate_stream([1, 2], 3, corr=corr))
        out["status"] = err.value.status
        assert router.failovers == 0
    elif case == "status_503":
        stubs[1].queue_depth = 9.0
        router.probe()
        stubs[0].fail_status = 503
        out["chains"] = router.generate([[5, 6]], 3, corr=corr)
        assert out["chains"] == [[5, 6] + scripted_chain([5, 6], 3)]
        assert router.failovers == 1
    elif case == "draining":
        router.set_draining("r0", True)
        out["chains"] = [router.generate([[2, 3]], 2, corr=corr) for _ in range(3)]
        assert (stubs[0].calls, stubs[1].calls) == (0, 3)
    elif case == "no_ready":
        for stub in stubs:
            stub.ready_flag = False
        router.probe()
        with pytest.raises(side.router.NoReadyReplicas):
            list(router.generate_stream([1, 2], 2, timeout=0.2, corr=corr))
    else:
        stubs[0].die_after = 1
        out["chains"] = router.generate([[4, 5]], 4, timeout=10.0, corr=corr)
        assert out["chains"] == [[4, 5] + scripted_chain([4, 5], 4)]
        assert stubs[0].calls == 2
    return dict(observed(router, flight, [corr]), out=out,
                calls=[stub.calls for stub in stubs],
                ready=[router.stats()["replicas"][f"r{i}"]["ready"] for i in range(len(stubs))])


@pytest.mark.parametrize("case", ["least_loaded", "mid_stream", "status_400", "status_503",
                                  "draining", "no_ready", "second_chance"])
def test_router_failover_on_scripted_replicas(case):
    seen = {name: _script(case, side) for name, side in SIDES.items()}
    if "ref" in seen:
        assert seen["port"] == seen["ref"]
