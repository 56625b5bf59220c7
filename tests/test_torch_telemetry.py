"""The port's telemetry plane (tf_operator_tpu_torch/telemetry/: the metric
history, the alert rules, the sampling profiler and /debug/flightz) held
against the JAX package's telemetry (tf_operator_tpu/telemetry/, stdlib
only) on the CPU.

Each scenario is one FakeClock script, the scripts of tests/test_history.py,
tests/test_alerts.py and tests/test_flight.py, run once against each
package: the windowed queries, the alert transitions and the rendered
/debug/historyz and /debug/alertz pages must be equal (the pages as
parsed JSON). The sampler is held by its mechanism only (samples taken,
folded stacks that name the sampled thread, start/stop idempotence): its
duty cycle is a wall-clock ratio, held on the card by chip_smoke.py's
`train_observe_smoke` phase, not here.
"""

import json
import threading
import types
from contextlib import contextmanager

import pytest

try:
    from tf_operator_tpu.controller import clock as ref_clock
    from tf_operator_tpu.telemetry import alerts as ref_alerts
    from tf_operator_tpu.telemetry import flight as ref_flight
    from tf_operator_tpu.telemetry import history as ref_history
    from tf_operator_tpu.telemetry import profiler as ref_profiler
    from tf_operator_tpu.telemetry import registry as ref_registry
except ImportError:  # a card machine without the JAX package's deps
    ref_clock = None

from tf_operator_tpu_torch.controller import clock as port_clock
from tf_operator_tpu_torch.telemetry import alerts as port_alerts
from tf_operator_tpu_torch.telemetry import flight as port_flight
from tf_operator_tpu_torch.telemetry import history as port_history
from tf_operator_tpu_torch.telemetry import profiler as port_profiler
from tf_operator_tpu_torch.telemetry import registry as port_registry

INF = float("inf")
SLO = 0.25  # a TTFT bucket edge, as the real rules use


def _pkg(name):
    if name == "ref":
        if ref_clock is None:
            pytest.skip("the JAX package is not importable")
        mods = (ref_clock, ref_alerts, ref_flight, ref_history, ref_profiler, ref_registry)
    else:
        mods = (port_clock, port_alerts, port_flight, port_history, port_profiler,
                port_registry)
    clock, alerts, flight, history, profiler, registry = mods
    return types.SimpleNamespace(
        FakeClock=clock.FakeClock, MetricRegistry=registry.MetricRegistry,
        TTFT_BUCKETS=registry.TTFT_BUCKETS, MetricHistory=history.MetricHistory,
        render_historyz=history.render_historyz, AlertManager=alerts.AlertManager,
        BurnRateRule=alerts.BurnRateRule, ThresholdRule=alerts.ThresholdRule,
        render_alertz=alerts.render_alertz, serve_replica_rules=alerts.serve_replica_rules,
        train_rules=alerts.train_rules, FlightRecorder=flight.FlightRecorder,
        correlate=flight.correlate, render_flightz=flight.render_flightz,
        SamplingProfiler=profiler.SamplingProfiler, render_profilez=profiler.render_profilez,
        top_table=profiler.top_table, speedscope_from_folded=profiler.speedscope_from_folded,
    )


def both(scenario):
    """-> (the reference's result, the port's result) of one scenario."""
    return scenario(_pkg("ref")), scenario(_pkg("port"))


# -- the metric history ----------------------------------------------------------

def _history_queries(m):
    """tests/test_history.py's TestRing and TestQueries scripts: -> every
    query's answer."""
    out = {}
    clock = m.FakeClock()
    history = m.MetricHistory(capacity=8, clock=clock)
    for i in range(20):
        clock.advance(1.0)
        history.ingest_value("depth", "gauge", float(i))
    out["wrap"] = [s[2] for s in history.samples("depth", window_s=1e9)]

    clock = m.FakeClock()
    history = m.MetricHistory(capacity=4, clock=clock)
    reg = m.MetricRegistry("t")
    c = reg.counter("ops_total", "ops")
    history.track_registry(reg)
    for _ in range(10):
        clock.advance(5.0)
        c.inc(2)
        history.tick()
    out["wrap_mid_window"] = (len(history.samples("t_ops_total", 100.0)),
                              history.delta("t_ops_total", 100.0))

    clock = m.FakeClock()
    history = m.MetricHistory(capacity=64, clock=clock)
    reg = m.MetricRegistry("t")
    reqs = reg.counter("reqs_total", "requests")
    fam = reg.counter("verbs_total", "ops", labelnames=("verb",))
    history.track_registry(reg)
    values = iter([100.0, 120.0, 5.0, 7.0, 9.0])
    history.track_provider("restarts_total", "counter", lambda: next(values))
    depth = {"v": 0.0}
    history.track_flat(lambda: {("engine_queue_depth", "gauge"): depth["v"]})

    def broken():
        raise RuntimeError("boom")

    history.track_provider("bad", "gauge", broken)
    for d in (1.0, 4.0, 2.0, 3.0, 5.0):
        clock.advance(10.0)
        reqs.inc(3)
        fam.labels(verb="get").inc(1)
        fam.labels(verb="put").inc(2)
        depth["v"] = d
        history.tick()
    out["queries"] = [
        history.delta("t_reqs_total", 40.0), history.rate("t_reqs_total", 40.0),
        history.delta("t_reqs_total", 5.0), history.delta("restarts_total", 100.0),
        history.delta('t_verbs_total{verb="get"}', 100.0),
        history.delta("t_verbs_total", 100.0), history.latest("engine_queue_depth"),
        history.sample_errors, history.ticks, history.series_names(),
    ]
    return out


def test_history_queries_match_the_reference():
    ref, port = both(_history_queries)
    assert port == ref
    # the reference tests' own expectations hold on the port's answers
    assert port["wrap"] == [float(i) for i in range(12, 20)]
    assert port["wrap_mid_window"] == (4, pytest.approx(6.0))
    assert port["queries"][:4] == [pytest.approx(12.0), pytest.approx(0.3), None, 9.0]


def _histogram_windows(m):
    """TestHistogramWindows' scripts, then /debug/historyz pages."""
    out = {}
    clock = m.FakeClock()
    history = m.MetricHistory(capacity=64, clock=clock)
    reg = m.MetricRegistry("t")
    lat = reg.histogram("lat_seconds", "latency", buckets=m.TTFT_BUCKETS)
    ttft = reg.histogram("ttft_seconds", "ttft", buckets=m.TTFT_BUCKETS,
                         labelnames=("tenant",))
    reqs = reg.counter("reqs_total", "requests")
    history.track_registry(reg)
    clock.advance(5.0)
    history.tick()
    for batch in ([0.004] * 50, [0.4] * 50):
        for v in batch:
            lat.observe(v)
        for i, v in enumerate([0.001 + (j % 40) * 0.004 for j in range(100)]):
            ttft.labels(tenant=("a", "b")[i % 2]).observe(v)
        reqs.inc()
        clock.advance(5.0)
        history.tick()
    out["recent"] = history.quantile_over_window("t_lat_seconds", 0.95, 6.0)
    out["overall"] = history.quantile_over_window("t_lat_seconds", 0.5, 60.0)
    out["ttft_p95"] = history.quantile_over_window("t_ttft_seconds", 0.95, 60.0)
    out["bad"] = history.bad_fraction("t_lat_seconds", 0.25, 60.0)
    out["bucket_delta"] = history.bucket_delta('t_ttft_seconds{tenant="a"}', 60.0)
    clock.advance(1.0)
    history.ingest_histogram("fleet", [(0.1, 10.0), (0.5, 15.0), (INF, 20.0)])
    clock.advance(1.0)
    history.ingest_histogram("fleet", [(0.1, 12.0), (0.5, 25.0), (INF, 30.0)])
    out["ingested"] = history.bucket_delta("fleet", 10.0)
    clock.advance(1.0)
    history.ingest_histogram("fleet", [(0.2, 1.0), (INF, 3.0)])
    out["schema_change"] = history.bucket_delta("fleet", 1.5)
    out["pages"] = [
        json.loads(m.render_historyz(history, query))
        for query in ("", "series=t_lat&q=0.95&window=60",
                      "series=t_reqs_total&points=1&window=30", "window=bogus&q=2")
    ]
    return out


def test_histogram_windows_and_historyz_match_the_reference():
    ref, port = both(_histogram_windows)
    assert port == ref
    assert port["recent"] > 0.25 and port["overall"] < 0.25
    assert port["bad"] == pytest.approx(0.5)
    assert port["schema_change"] == []
    assert [r["series"] for r in port["pages"][1]["series"]] == ["t_lat_seconds"]
    assert "p95" in port["pages"][1]["series"][0] and "points" in port["pages"][2]


# -- the alert rules -------------------------------------------------------------

def _manager(m, rules):
    clock = m.FakeClock()
    history = m.MetricHistory(capacity=512, clock=clock)
    flight = m.FlightRecorder()
    registry = m.MetricRegistry("t")
    manager = m.AlertManager(history, rules, registry=registry, clock=clock, flight=flight)
    return manager, history, clock, flight, registry


def _burn_rate_script(m):
    """TestBurnRate's script (spike, sustained burn, recovery, then a
    silent series and a partial pass): -> the transitions of every
    evaluation, the firing sets at each stage and the /debug/alertz
    pages."""
    rule = m.BurnRateRule("ttft-slo", "ttft", threshold_s=SLO, objective=0.95,
                          windows=((60.0, 14.4), (300.0, 6.0)))
    manager, history, clock, _, _ = _manager(m, [rule])
    counts = {"good": 0.0, "total": 0.0}
    transitions, firing = [], []

    def tick(good=0, bad=0, partial=None):
        clock.advance(10.0)
        counts["good"] += good
        counts["total"] += good + bad
        history.ingest_histogram("ttft", [(SLO, counts["good"]), (INF, counts["total"])])
        transitions.append(manager.evaluate(partial=partial))

    for n, good, bad, partial in ((40, 10, 0, None), (6, 0, 10, None), (13, 0, 10, None),
                                  (7, 10, 0, None), (8, 0, 10, None), (12, 10, 0, True),
                                  (30, 10, 0, False)):
        for _ in range(n):
            tick(good, bad, partial)
        firing.append(manager.firing())
    clock.advance(600.0)
    transitions.append(manager.evaluate())  # no data holds the state
    pages = [json.loads(m.render_alertz(manager, q)) for q in ("", "firing=1")]
    return {"transitions": transitions, "firing": firing, "pages": pages}


def test_burn_rate_transitions_match_the_reference():
    ref, port = both(_burn_rate_script)
    assert port == ref
    assert port["firing"][:4] == [[], ["ttft-slo[60s]"], ["ttft-slo[60s]", "ttft-slo[300s]"],
                                  ["ttft-slo[300s]"]]
    assert "ttft-slo[60s]" in port["firing"][5]  # a partial pass never resolves
    assert sum(len(t) for t in port["transitions"]) >= 4


def _threshold_script(m):
    """TestThreshold's and TestTransitions' scripts: hysteresis, the for_s
    damper, ratio and rate modes, trace-carrying alert records and the
    firing gauge."""
    rules = [
        m.ThresholdRule("depth", "depth", fire_above=10.0, resolve_below=5.0),
        m.ThresholdRule("damped", "depth", fire_above=10.0, resolve_below=5.0, for_s=15.0),
        m.ThresholdRule("kv", "used", denominator="total", mode="ratio", fire_above=0.9,
                        resolve_below=0.75),
        m.ThresholdRule("errors", "errs_total", mode="rate", window_s=30.0, fire_above=0.0),
    ]
    manager, history, clock, flight, registry = _manager(m, rules)
    flight.record("serve", op="route", trace="aaaa1111")
    flight.record("serve", op="route", trace="bbbb2222")
    transitions = []
    for depth, used, errs in ((50, 95, 0), (8, 95, 0), (50, 70, 1), (50, 80, 3), (4, 10, 3),
                              (11, 95, 3), (12, 95, 3), (3, 10, 3)):
        clock.advance(10.0)
        history.ingest_value("depth", "gauge", float(depth))
        history.ingest_value("used", "gauge", float(used))
        history.ingest_value("total", "gauge", 100.0)
        history.ingest_value("errs_total", "counter", float(errs))
        transitions.append(manager.evaluate())
    records = [(r.fields["rule"], r.fields["state"], r.fields["value"],
                sorted(r.fields["traces"].split(",")))
               for r in flight.snapshot(kind="alert")]
    gauge = sorted(line for line in registry.render().splitlines()
                   if line.startswith("t_alerts_firing{"))
    return {"transitions": transitions, "records": records, "gauge": gauge,
            "page": json.loads(m.render_alertz(manager, ""))}


def test_threshold_rules_match_the_reference():
    ref, port = both(_threshold_script)
    assert port == ref
    assert port["records"][0][:2] == ("depth", "firing")
    assert {"aaaa1111", "bbbb2222"} <= set(port["records"][0][3])


def _rule_packs(m):
    """The serve replica and training rule packs, instantiated and
    rendered before any data."""
    pages = []
    for rules in (m.serve_replica_rules(prefix="tf_operator_tpu_serve", ttft_slo_s=0.25),
                  m.train_rules(["worker-0", "worker-1"], straggler_ratio=0.7, stall_k=8.0)):
        manager = _manager(m, rules)[0]
        manager.evaluate()
        pages.append(json.loads(m.render_alertz(manager, "")))
    return pages


def test_rule_packs_match_the_reference():
    ref, port = both(_rule_packs)
    assert port == ref
    keys = {i["instance"] for i in port[0]["instances"]}
    assert {"ttft-slo[60s]", "ttft-slo[300s]", "queue-depth", "kv-occupancy"} <= keys
    assert {i["instance"] for i in port[1]["instances"]} == {
        "train-straggler[worker-0]", "train-stall[worker-0]",
        "train-straggler[worker-1]", "train-stall[worker-1]",
    }


# -- /debug/flightz --------------------------------------------------------------

def _flightz(m):
    """TestFlightz's ring, filtered by every parameter: -> the pages with
    the wall clock left out (each recorder reads the host's)."""
    clock = m.FakeClock()
    rec = m.FlightRecorder(capacity=64, clock=clock.monotonic)
    with m.correlate("uid-1"):
        rec.record("reconcile", op="sync", key="ns/a", decision="ok")
        clock.advance(1.0)
        rec.record("event", reason="Created", obj="ns/a", trace="t1")
    with m.correlate("uid-2"):
        rec.record("reconcile", op="sync", key="ns/b", decision="ok", blob=object)
    rec.record("workqueue", op="add", key="ns/a", corr="uid-3")
    pages = {}
    for query in ("", "corr=uid-1", "request=uid-1", "kind=reconcile",
                  "kind=reconcile&limit=1", "job=uid-2", "job=ns/a", "trace=t1",
                  "since=0", "limit=bogus", "corr=nope"):
        body = m.render_flightz(rec, query)
        rows = [json.loads(line) for line in body.decode().splitlines() if line]
        for row in rows:
            del row["wall"]
        pages[query] = rows
    return pages


def test_flightz_matches_the_reference():
    ref, port = both(_flightz)
    assert port == ref
    assert [r["corr"] for r in port["request=uid-1"]] == ["uid-1", "uid-1"]
    assert {r["kind"] for r in port["job=ns/a"]} == {"reconcile", "workqueue", "event"}
    assert port["corr=nope"] == []
    assert port[""][2]["fields"]["blob"] == str(object)  # stringified, as the reference


# -- the sampling profiler -------------------------------------------------------

@contextmanager
def parked_thread(name):
    """A live thread parked in a function of this file, named `name`."""
    release = threading.Event()
    started = threading.Event()

    def park_here():
        started.set()
        release.wait(10)

    thread = threading.Thread(target=park_here, name=name, daemon=True)
    thread.start()
    started.wait(5)
    try:
        yield thread
    finally:
        release.set()
        thread.join(5)


def test_sampler_folds_the_sampled_threads_stacks():
    prof = port_profiler.SamplingProfiler(hz=99, capacity=8)
    with parked_thread("decode-engine"), parked_thread("train-step-worker-0"), \
            parked_thread("bespoke-thread"):
        for _ in range(6):
            assert prof._sample_once() >= 3
    snap = prof.snapshot()
    assert len(snap) == 8 and [s.seq for s in snap] == list(
        range(prof.total_sampled - 8, prof.total_sampled))
    prof = port_profiler.SamplingProfiler(capacity=256)
    with parked_thread("decode-engine"), parked_thread("train-step-worker-0"), \
            parked_thread("bespoke-thread"):
        prof._sample_once()
    folded = prof.folded()
    for role in ("engine", "train-step", "bespoke-thread"):
        stacks = [k for k in folded if k.startswith(role + ";")]
        assert stacks and all(k.endswith("test_torch_telemetry.py:park_here;"
                                         "threading.py:wait;threading.py:wait")
                              for k in stacks), (role, stacks)
    # the sampling thread never profiles itself
    assert not any("test_sampler_folds_the_sampled_threads_stacks" in k for k in folded)
    with pytest.raises(ValueError):
        port_profiler.SamplingProfiler(hz=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_walk_folds_as_a_fresh_fold(seed):
    """A tick looks each stack's fold up by its code objects (_walk):
    along a random walk of one thread's stack, deeper than
    MAX_STACK_DEPTH at times, each tick's fold equals a fresh _fold of
    the same frame, a stack seen before is formatted once, and the cache
    holds code objects, no frame."""
    import random
    import sys
    import types

    rng = random.Random(seed)
    folds = {}
    seen = {"checked": 0, "stacks": set()}

    def tick():
        frame = sys._getframe(1)
        fold = port_profiler._walk(frame, folds)
        assert fold == port_profiler._fold(frame)
        assert port_profiler._walk(frame, folds) is fold  # the cached string
        seen["stacks"].add(fold)
        seen["checked"] += 1

    def down(n):
        if rng.random() < 0.3:
            tick()
        if n:
            down(n - 1) if rng.random() < 0.7 else side(max(0, n - 2))
        tick()
        if rng.random() < 0.2:
            tick()  # the same leaf frame again

    def side(n):
        down(n)

    for _ in range(60):
        down(rng.randint(0, 2 * port_profiler.MAX_STACK_DEPTH))
    assert seen["checked"] > 500
    assert len(folds) == len(seen["stacks"]) < seen["checked"]
    assert all(isinstance(code, types.CodeType)
               for _, codes in folds.values() for code in codes)


def test_sampler_defers_the_garbage_collector_during_a_tick(monkeypatch):
    """The cyclic collector is off inside every tick of the sampling loop
    (a collection a tick would trigger runs on the next thread to
    allocate, not charged to the sampler) and on again after it."""
    import gc
    import time

    inside = []
    prof = port_profiler.SamplingProfiler(hz=200)
    monkeypatch.setattr(prof, "_sample_once", lambda: inside.append(gc.isenabled()) or 0)
    assert gc.isenabled()
    prof.start()
    deadline = time.monotonic() + 5
    while len(inside) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    prof.stop()
    assert len(inside) >= 5 and not any(inside)
    assert gc.isenabled()


def test_sampler_start_stop_and_profilez_actions():
    prof = port_profiler.SamplingProfiler(hz=200)
    try:
        assert prof.start() is True and prof.start() is False and prof.running
        ctype, body = port_profiler.render_profilez(prof, "action=start")
        assert ctype == "application/json" and json.loads(body)["started"] is False
    finally:
        assert json.loads(port_profiler.render_profilez(prof, "action=stop")[1])["stopped"]
    assert prof.stop() is False and not prof.running
    assert prof.stats()["ticks"] >= 1
    # a snapshot with seconds= against a stopped profiler captures that
    # window, then stops again
    fresh = port_profiler.SamplingProfiler(hz=200)
    payload = json.loads(port_profiler.render_profilez(fresh, "seconds=0.05&format=json")[1])
    assert payload["profile"] == "tf-operator-tpu-sampling" and payload["samples"] > 0
    assert not fresh.running
    assert "speedscope" in json.loads(
        port_profiler.render_profilez(fresh, "format=speedscope")[1])["$schema"]
    ctype, body = port_profiler.render_profilez(fresh, "")
    lines = body.decode().strip().splitlines()
    assert ctype.startswith("text/plain") and lines
    assert all(line.rsplit(" ", 1)[1].isdigit() for line in lines)


FOLDED = {"engine;a.py:f;b.py:g": 3, "engine;a.py:f": 2, "main;c.py:h": 1,
          "train-step;d.py:k;a.py:f": 4}


def test_profile_analysis_matches_the_reference():
    ref, port = both(lambda m: (m.top_table(FOLDED, n=5),
                                m.speedscope_from_folded({"folded": FOLDED, "hz": 100})))
    assert port == ref
    assert port[0]["cumulative"][0] == ("a.py:f", 9)
