"""The port's telemetry CLI (`python -m tf_operator_tpu_torch.telemetry`,
telemetry/__main__.py), its crash and SIGUSR2 dumps (telemetry/flight.py
install_crash_handlers, profiler.py write_signal_snapshot), operator_rules
and the decode server's --smoke, on the CPU, against the JAX package.

Criteria:
- the CLI against the reference's: tests/test_flight.py TestCli's scenarios
  and `profile --input` on one saved payload run through both packages'
  `main`, on the same files; stdout, stderr, exit codes and the written
  Perfetto/folded/speedscope files must be equal once the package name is
  normalized;
- the live subcommands (tracez, historyz, alertz, kvz, trainz, profile
  --url) against port servers, a port router's observatory and port
  trainer telemetry servers in threads: both CLIs are pointed at the same
  URLs (the pages are the wire contract). A page whose content moves with
  time is fetched through a replaying proxy, so both CLIs read the same
  bytes; tracez's direct form handshakes clocks itself, so its numbers are
  masked and everything else is compared;
- the crash surfaces: the twins of tests/test_flight.py TestCrashDumps and
  tests/test_profiler.py TestSignalSnapshot, plus one child process that
  installs the handlers, takes a SIGUSR2 while an engine-named thread runs
  and then dies of a planted exception; its dumps merge through both CLIs
  with equal output;
- operator_rules: one FakeClock script through AlertManager in both
  packages, transitions and pages equal;
- `serve --smoke --device cpu` exits 0 with ok true, its report's keys are
  the reference `_smoke`'s, and without a card and without --device it
  fails naming CUDA.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

import tf_operator_tpu_torch.telemetry as port_telemetry
from tf_operator_tpu_torch.controller.clock import FakeClock
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.serve import server as torch_server
from tf_operator_tpu_torch.serve.observatory import make_observatory
from tf_operator_tpu_torch.serve.router import LeastLoadedRouter
from tf_operator_tpu_torch.telemetry import __main__ as port_cli
from tf_operator_tpu_torch.telemetry import alerts as port_alerts
from tf_operator_tpu_torch.telemetry import flight as port_flight
from tf_operator_tpu_torch.telemetry import history as port_history
from tf_operator_tpu_torch.telemetry import profiler as port_profiler
from tf_operator_tpu_torch.telemetry.collector import HOP_NAMES
from tf_operator_tpu_torch.telemetry.registry import MetricRegistry
from tf_operator_tpu_torch.train import observe

try:
    import tf_operator_tpu.telemetry as ref_telemetry
    from tf_operator_tpu.controller import clock as ref_clock
    from tf_operator_tpu.telemetry import __main__ as ref_cli
    from tf_operator_tpu.telemetry import alerts as ref_alerts
    from tf_operator_tpu.telemetry import flight as ref_flight
    from tf_operator_tpu.telemetry import history as ref_history
except ImportError:  # a card machine without the JAX package's deps
    ref_cli = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 8
SHARED = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]  # two blocks


def _need_ref():
    if ref_cli is None:
        pytest.skip("the JAX package is not importable")


def _norm(text):
    return text.replace("tf_operator_tpu_torch", "tf_operator_tpu")


def _run(main, argv):
    """-> (exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(argv))
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


def _both(argv_of, tmp_path):
    """Run the reference's CLI, then the port's, each with the argv that
    argv_of(directory) builds for its own output directory; -> the two
    (rc, stdout, stderr) with each directory named <out>, and the dirs."""
    results, dirs = [], []
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        out_dir = tmp_path / f"out-{name}"
        out_dir.mkdir(exist_ok=True)
        rc, out, err = _run(cli.main, argv_of(str(out_dir)))
        results.append((rc, _norm(out.replace(str(out_dir), "<out>")),
                        _norm(err.replace(str(out_dir), "<out>"))))
        dirs.append(out_dir)
    return results, dirs


def _files_equal(dirs):
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1]))
    for name in names:
        a, b = ((d / name).read_text() for d in dirs)
        if name.endswith(".json"):
            assert json.loads(_norm(b)) == json.loads(_norm(a)), name
        else:
            assert _norm(b) == _norm(a), name
    return names


# -- the offline forms: tests/test_flight.py TestCli's scenarios -------------------

def _dump(tmp_path, name="d.jsonl", corr="req-9", step=50):
    """TestCli's dump, written by the port's recorder (the same JSONL the
    reference's writes)."""
    rec = port_flight.FlightRecorder(capacity=16)
    with port_flight.correlate(corr):
        rec.record("serve", op="submit")
        rec.record("serve", op="admit", slot=0)
    rec.record("train", op="step-stats", step=step, loss=1.5)
    path = tmp_path / name
    path.write_text(rec.to_jsonl())
    return str(path)


@pytest.mark.parametrize("extra", [
    [], ["--corr", "req-9"], ["--kind", "train"], ["--limit", "2"], ["--corr", "nope"],
], ids=["bare", "corr", "kind", "limit", "no-match"])
def test_timeline_matches_the_reference(tmp_path, extra):
    _need_ref()
    path = _dump(tmp_path)
    (ref, port), _ = _both(lambda out: [path, *extra], tmp_path)
    assert port == ref
    assert port[0] == 0
    if not extra:
        assert "# 3 records, 1 correlation IDs, 1 dump(s)" in port[1]
        assert "[req-9]" in port[1] and "op=step-stats" in port[1]
    if extra[:1] == ["--corr"] and extra[1] == "req-9":
        assert "# 2 records" in port[1] and "train" not in port[1]


def test_two_dumps_merge_like_the_reference(tmp_path):
    _need_ref()
    first = _dump(tmp_path, "a.jsonl", corr="req-1", step=1)
    second = _dump(tmp_path, "b.jsonl", corr="req-2", step=2)
    (ref, port), _ = _both(lambda out: [first, second], tmp_path)
    assert port == ref
    assert "# 6 records, 2 correlation IDs, 2 dump(s)" in port[1]
    assert f"<{first}>" in port[1] and f"<{second}>" in port[1]


def test_perfetto_export_matches_the_reference(tmp_path):
    _need_ref()
    path = _dump(tmp_path)
    trace = tmp_path / "debug-trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": "serve-request", "ph": "X", "ts": 1.0, "dur": 5.0, "pid": 0, "tid": 1,
         "args": {"corr": "req-9"}}]}))
    (ref, port), dirs = _both(
        lambda out: [path, "--quiet", "--perfetto", os.path.join(out, "flight-trace.json"),
                     "--trace", str(trace)], tmp_path)
    assert port == ref and port[0] == 0
    assert port[1] == "wrote <out>/flight-trace.json (5 events)\n"
    assert _files_equal(dirs) == ["flight-trace.json"]
    events = json.loads((dirs[1] / "flight-trace.json").read_text())["traceEvents"]
    instants = [e for e in events if e.get("ph") == "i"]
    assert {e["name"] for e in instants} == {"serve:submit", "serve:admit", "train:step-stats"}
    metas = [e for e in events if e.get("ph") == "M"]
    corr_tid = next(e["tid"] for e in metas if e["args"]["name"] == "flight:req-9")
    assert all(e["tid"] == corr_tid for e in instants if e["args"].get("corr") == "req-9")
    assert events[0]["name"] == "serve-request"  # the span leads the merged file


@pytest.mark.parametrize("content, where", [
    ('{"kind": "x"}\nnot json\n', "bad.jsonl:2"),
    ('{"kind": "x"}\n[1, 2]\n', "bad.jsonl:2"),
], ids=["not-json", "no-kind"])
def test_bad_dump_is_the_same_named_error(tmp_path, content, where):
    _need_ref()
    bad = tmp_path / "bad.jsonl"
    bad.write_text(content)
    (ref, port), _ = _both(lambda out: [str(bad)], tmp_path)
    assert port == ref
    assert port[0] == 1 and where in port[2]


def test_chrome_events_accept_records_and_dicts():
    _need_ref()
    rec = port_flight.FlightRecorder(capacity=4)
    r = rec.record("x", op="a")
    assert port_flight.flight_chrome_events([r])[-1]["name"] == "x:a"
    assert port_flight.flight_chrome_events([r.to_dict()])[-1]["name"] == "x:a"
    with port_flight.correlate("c-1"):
        rows = [rec.record("serve", op="step", step=i).to_dict() for i in range(3)]
    rows.append(rec.record("serve", op="route").to_dict())
    assert port_flight.flight_chrome_events(rows, pid=3) == \
        ref_flight.flight_chrome_events(rows, pid=3)


# -- profile --input ---------------------------------------------------------------

def _payload(seed=0):
    """A to_json()-shaped profile payload with seeded folded counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    roles = ("engine", "server", "main")
    frames = [f"m{i}.py:f{i}" for i in range(8)]
    folded = {}
    for _ in range(24):
        depth = int(rng.integers(1, 5))
        stack = ";".join([roles[int(rng.integers(3))]] +
                         [frames[int(rng.integers(8))] for _ in range(depth)])
        folded[stack] = folded.get(stack, 0) + int(rng.integers(1, 40))
    return {"profile": "tf-operator-tpu-sampling", "hz": 99, "samples": sum(folded.values()),
            "duration_seconds": 5.0, "wall_start": 1792300000.25, "folded": folded}


@pytest.mark.parametrize("form", ["tables", "top3", "exports", "perfetto", "not-a-payload"])
def test_profile_input_matches_the_reference(tmp_path, form):
    _need_ref()
    payload = tmp_path / "p.json"
    payload.write_text(json.dumps({"bogus": 1} if form == "not-a-payload" else _payload()))
    flight_dump = _dump(tmp_path)
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [{"name": "s", "ph": "X", "ts": 0, "dur": 1,
                                                  "pid": 0, "tid": 1}]}))

    def argv(out):
        base = ["profile", "--input", str(payload)]
        return base + {
            "tables": [],
            "top3": ["--top", "3"],
            "exports": ["--quiet", "--out", os.path.join(out, "raw.json"),
                        "--folded", os.path.join(out, "p.folded"),
                        "--speedscope", os.path.join(out, "p.speedscope.json")],
            "perfetto": ["--quiet", "--perfetto", os.path.join(out, "merged.json"),
                         "--trace", str(trace), "--flight", flight_dump],
            "not-a-payload": [],
        }[form]

    (ref, port), dirs = _both(argv, tmp_path)
    assert port == ref
    _files_equal(dirs)
    if form == "not-a-payload":
        assert port[0] == 1 and "not a profile payload" in port[2]
        return
    assert port[0] == 0
    if form == "tables":
        assert "# roles" in port[1] and "# top 15 self" in port[1]
    if form == "perfetto":
        events = json.loads((dirs[1] / "merged.json").read_text())["traceEvents"]
        assert {e.get("cat") for e in events} >= {"profile", "flight"}


def test_unknown_profile_input_file_is_an_error_in_both(tmp_path):
    _need_ref()
    (ref, port), _ = _both(lambda out: ["profile", "--input", str(tmp_path / "none.json")],
                           tmp_path)
    assert port == ref and port[0] == 1 and port[2].startswith("error:")


# -- the live subcommands ----------------------------------------------------------

class _Replay(ThreadingHTTPServer):
    """GET proxy to one upstream that answers each path from the first
    upstream answer it got (clockz excepted), so two CLIs run one after
    the other read the same bytes; clear() starts over."""

    daemon_threads = True

    def __init__(self, upstream):
        self.upstream = upstream.rstrip("/")
        self.cache = {}
        self.lock = threading.Lock()
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                with proxy.lock:
                    hit = proxy.cache.get(self.path)
                if hit is None or self.path.startswith("/debug/clockz"):
                    try:
                        with urllib.request.urlopen(proxy.upstream + self.path,
                                                    timeout=120) as resp:
                            hit = (resp.status, resp.headers.get("Content-Type"), resp.read())
                    except urllib.error.HTTPError as err:
                        hit = (err.code, err.headers.get("Content-Type"), err.read())
                    with proxy.lock:
                        proxy.cache[self.path] = hit
                status, ctype, body = hit
                self.send_response(status)
                self.send_header("Content-Type", ctype or "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server_address[1]}"

    def clear(self):
        with self.lock:
            self.cache.clear()

    def close(self):
        self.shutdown()
        self.server_close()


def _fake_trainer(registry, steps):
    trainer = types.SimpleNamespace(
        metrics_registry=registry, health=observe.HealthPhase(),
        phase_timer=observe.StepPhaseTimer(registry, clock=FakeClock()),
        goodput=observe.GoodputLedger(registry),
    )
    trainer.health.set("training")
    trainer.goodput.useful(2.0, steps=steps)
    trainer.goodput.waste("checkpoint", 0.5)
    registry.counter("train_steps_total", "steps").inc(steps)
    return trainer


@pytest.fixture(scope="module")
def live():
    """Two port servers (prefill and decode roles) behind a port router
    that served two shared-prefix streams (one migrated), its observatory
    with a scriptable level alert, and two trainer telemetry servers plus
    a third carrying their TrainFleetView."""
    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    model = torch_gpt.GPT(cfg, generator=torch.Generator().manual_seed(3))
    servers, stops = {}, []
    try:
        for name, role in (("p", "prefill"), ("d", "decode")):
            srv = torch_server.make_server(
                model, batching="continuous", n_slots=2, block_size=BS, prefill_chunk=BS,
                max_new_cap=64, device="cpu", role=role, enable_debug_endpoints=True,
            )
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers[name] = srv
            stops.append(lambda srv=srv: (srv.shutdown(), srv.state.engine.stop(),
                                          srv.server_close()))
        urls = {n: f"http://127.0.0.1:{s.server_address[1]}" for n, s in servers.items()}
        router = LeastLoadedRouter(retry_wait=0.01, stream_deadline=120.0)
        for name, role in (("p", "prefill"), ("d", "decode")):
            router.add_replica(name, urls[name], role=role)
        traces = []
        for i, tail in enumerate(([31, 32], [41])):
            final = None
            for event in router.generate_stream(SHARED + tail, 6, corr=f"cli-{i}",
                                                timeout=120.0):
                if event.get("done"):
                    final = event
            traces.append(final["trace_id"])
        level_registry = MetricRegistry("cli")
        level = level_registry.gauge("level", "a scriptable level")
        history = port_history.MetricHistory(capacity=64)
        history.track_registry(level_registry)
        alerts = port_alerts.AlertManager(
            history, [port_alerts.ThresholdRule("cli-level", "cli_level", fire_above=0.5,
                                                resolve_below=0.5)],
            registry=router.registry,
        )
        obs = make_observatory(router, history=history, alerts=alerts)
        threading.Thread(target=obs.serve_forever, daemon=True).start()
        stops.append(lambda: (obs.shutdown(), obs.server_close()))

        workers, clients = {}, {}
        for i, steps in enumerate((12, 7)):
            registry = MetricRegistry("tf_operator_tpu")
            telemetry = observe.TrainTelemetry(trainer=_fake_trainer(registry, steps),
                                               worker=f"worker-{i}", history_interval_s=0.0)
            telemetry.start("127.0.0.1:0")
            stops.append(telemetry.stop)
            workers[f"worker-{i}"] = f"http://127.0.0.1:{telemetry.port}"
            clients[f"worker-{i}"] = observe.WorkerClient(workers[f"worker-{i}"])
        clock = FakeClock()
        view = observe.TrainFleetView(clients, clock=clock, rate_window_s=4.0)
        for _ in range(3):
            clock.advance(1.0)
            view.observe()
        fleet_telemetry = observe.TrainTelemetry(worker="train-observatory",
                                                 registry=MetricRegistry("tf_operator_tpu"),
                                                 history_interval_s=0.0, fleet_view=view)
        fleet_telemetry.start("127.0.0.1:0")
        stops.append(fleet_telemetry.stop)
        proxies = []

        def replay(url):
            proxy = _Replay(url)
            proxies.append(proxy)
            stops.append(proxy.close)
            return proxy

        yield types.SimpleNamespace(
            urls=urls, router=router, traces=traces, obs=f"http://127.0.0.1:"
            f"{obs.server_address[1]}", level=level, history=history, alerts=alerts,
            workers=workers, train_obs=f"http://127.0.0.1:{fleet_telemetry.port}",
            replay=replay,
        )
    finally:
        for stop in reversed(stops):
            stop()


def _live_both(argv):
    """Both CLIs on one argv; -> (ref, port) (rc, stdout, stderr)."""
    return (tuple(_norm(x) if isinstance(x, str) else x for x in _run(ref_cli.main, argv)),
            tuple(_norm(x) if isinstance(x, str) else x for x in _run(port_cli.main, argv)))


def test_tracez_through_the_observatory_matches_the_reference(live):
    _need_ref()
    proxy = live.replay(live.obs)
    migrated = 0
    for trace in live.traces:
        ref, port = _live_both(["tracez", "--trace", trace, "--observatory", proxy.url])
        assert port == ref and port[0] == 0
        names = [line.split()[0] for line in port[1].splitlines() if not line.startswith("#")]
        if "mode disaggregated" in port[1]:
            migrated += 1
            assert names == list(HOP_NAMES)
        assert "ORPHANS" not in port[1] and "missing" not in port[1]
    assert migrated >= 1


def test_tracez_perfetto_export_matches_the_reference(live, tmp_path):
    _need_ref()
    proxy = live.replay(live.obs)
    trace = live.traces[0]
    outs = []
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        path = str(tmp_path / f"{name}.json")
        rc, out, _ = _run(cli.main, ["tracez", "--trace", trace, "--observatory", proxy.url,
                                     "--quiet", "--perfetto", path])
        assert rc == 0 and out.startswith(f"wrote {path} (")
        outs.append(json.loads(open(path).read()))
    assert outs[1] == outs[0]
    assert {e["name"] for e in outs[1]["traceEvents"] if e.get("cat") == "hop"}


def test_tracez_direct_fan_out_matches_the_reference(live):
    """Each CLI handshakes the replicas' clocks itself: the numbers are
    masked, the rest (records, mode, hop order, replicas) compared."""
    _need_ref()

    def mask(text):
        return re.sub(r"#+$", "#", re.sub(r"-?\d+(\.\d+)?(e-?\d+)?s\b", "<x>s", text),
                      flags=re.M)

    for trace in live.traces:
        argv = ["tracez", "--trace", trace, "--samples", "2", live.urls["p"], live.urls["d"]]
        ref, port = _live_both(argv)
        assert (port[0], mask(port[1]), port[2]) == (ref[0], mask(ref[1]), ref[2])
        assert port[0] == 0 and "ORPHANS" not in port[1]


def test_tracez_argument_errors_match_the_reference(live):
    _need_ref()
    for argv in (["tracez", "--trace", "x"],
                 ["tracez", "--trace", "x", "--observatory", live.obs, live.urls["d"]]):
        ref, port = _live_both(argv)
        assert port == ref and port[0] == 2


@pytest.mark.parametrize("form", ["observatory", "direct", "series", "json"])
def test_historyz_matches_the_reference(live, form):
    _need_ref()
    live.history.tick()
    obs = live.replay(live.obs)
    replicas = [live.replay(live.urls[n]).url for n in ("p", "d")]
    argv = {
        "observatory": ["historyz", "--observatory", obs.url, "--window", "60", "--q", "0.95"],
        "direct": ["historyz", *replicas],
        "series": ["historyz", *replicas, "--series", "tf_operator_tpu_serve_ttft",
                   "--window", "300", "--q", "0.95"],
        "json": ["historyz", replicas[1], "--json"],
    }[form]
    ref, port = _live_both(argv)
    assert port == ref and port[0] == 0
    assert port[1].startswith("# ") or form == "json"


def test_alertz_exits_3_while_firing_and_0_after(live):
    _need_ref()
    proxy = live.replay(live.obs)
    codes = []
    for value in (1.0, 0.0):
        live.level.set(value)
        live.history.tick()
        live.alerts.evaluate()
        proxy.clear()
        for argv in (["alertz", "--observatory", proxy.url],
                     ["alertz", "--observatory", proxy.url, "--firing"],
                     ["alertz", "--observatory", proxy.url, "--json"]):
            ref, port = _live_both(argv)
            assert port == ref
            codes.append(port[0])
        if value:
            assert "# firing fleet-wide: cli-level" in port[1] or "cli-level" in port[1]
    assert codes == [3, 3, 3, 0, 0, 0]


def test_alertz_direct_fan_out_matches_the_reference(live):
    _need_ref()
    replicas = [live.replay(live.urls[n]).url for n in ("p", "d")]
    ref, port = _live_both(["alertz", *replicas])
    assert port == ref and port[0] in (0, 3)
    assert port[1].startswith("# firing fleet-wide:")


@pytest.mark.parametrize("form", ["observatory", "direct", "json", "top1"])
def test_kvz_matches_the_reference(live, form):
    _need_ref()
    obs = live.replay(live.obs)
    replicas = [live.replay(live.urls[n]).url for n in ("p", "d")]
    argv = {
        "observatory": ["kvz", "--observatory", obs.url],
        "direct": ["kvz", *replicas],
        "json": ["kvz", *replicas, "--json"],
        "top1": ["kvz", *replicas, "--top", "1"],
    }[form]
    ref, port = _live_both(argv)
    assert port == ref and port[0] == 0
    if form == "direct":
        assert "# fleet kv: duplication_factor=" in port[1] and "free=" in port[1]


@pytest.mark.parametrize("form", ["direct", "observatory", "json"])
def test_trainz_matches_the_reference(live, form):
    _need_ref()
    workers = sorted(live.workers.values())
    argv = {
        "direct": ["trainz", *workers],
        "observatory": ["trainz", "--observatory", live.train_obs],
        "json": ["trainz", *workers, "--json"],
    }[form]
    ref, port = _live_both(argv)
    assert port == ref and port[0] == 0
    if form == "direct":
        assert "phase=training" in port[1] and "checkpoint=0.5s" in port[1]
    if form == "observatory":
        assert "# train fleet: last_step=12" in port[1] and "worker-1" in port[1]


def test_trainz_scrape_failure_is_partial_in_both(live):
    _need_ref()
    ref, port = _live_both(["trainz", "http://127.0.0.1:9"])
    assert port[:2] == ref[:2] and port[0] == 1
    assert "SCRAPE FAILED" in port[2] and "SCRAPE FAILED" in ref[2]


def test_profile_url_matches_the_reference(live):
    _need_ref()
    proxy = live.replay(live.urls["d"])
    ref, port = _live_both(["profile", "--url", proxy.url, "--seconds", "0.2", "--hz", "200",
                            "--top", "5"])
    assert port == ref and port[0] == 0
    assert port[1].startswith("# ") and "# roles" in port[1]


# -- the crash surfaces: tests/test_flight.py TestCrashDumps' twins --------------

@pytest.fixture()
def flight():
    prev = port_flight.default_flight()
    rec = port_flight.set_default_flight(port_flight.FlightRecorder(capacity=1024))
    try:
        yield rec
    finally:
        port_flight.set_default_flight(prev)


def test_excepthook_dumps_ring_then_chains(flight, tmp_path):
    flight.record("reconcile", op="sync", key="ns/j")
    seen = []
    prev_hook = sys.excepthook
    stub = lambda *a: seen.append(a)  # noqa: E731
    sys.excepthook = stub
    try:
        handles = port_flight.install_crash_handlers(directory=str(tmp_path),
                                                     install_signal=False)
        try:
            try:
                raise RuntimeError("boom")
            except RuntimeError:
                with contextlib.redirect_stderr(io.StringIO()) as err:
                    sys.excepthook(*sys.exc_info())
        finally:
            handles.uninstall()
        assert sys.excepthook is stub
    finally:
        sys.excepthook = prev_hook
    assert len(handles.dumps) == 1
    path = handles.dumps[0]
    assert os.path.basename(path) == f"flight-crash-{os.getpid()}.jsonl"
    assert f"flight recorder dump: {path}" in err.getvalue()
    records = [json.loads(line) for line in open(path) if line.strip()]
    assert any(r["kind"] == "reconcile" for r in records)
    assert len(seen) == 1 and seen[0][0] is RuntimeError


def test_all_thread_stacks():
    out = port_flight.all_thread_stacks()
    assert "thread" in out.lower() and "File" in out


def test_crash_dump_not_blocked_by_a_lock_held_by_another_thread(tmp_path):
    rec = port_flight.FlightRecorder(capacity=8)
    rec.record("reconcile", op="sync", key="ns/x")
    held, release = threading.Event(), threading.Event()

    def holder():
        with rec._lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    try:
        start = time.monotonic()
        path = rec.crash_dump(str(tmp_path / "dump.jsonl"))
        elapsed = time.monotonic() - start
    finally:
        release.set()
        t.join(5)
    assert elapsed < 2.0
    records = [json.loads(line) for line in open(path) if line.strip()]
    assert any(r["kind"] == "reconcile" for r in records)


def test_crash_dump_not_blocked_by_a_lock_its_own_thread_holds(tmp_path):
    """The signal case itself: the port's ring lock is a plain Lock, so
    the interrupted thread re-entering it would block forever; the
    timeout and the lock-free copy return promptly."""
    rec = port_flight.FlightRecorder(capacity=8)
    for i in range(10):
        rec.record("serve", op="step", step=i)
    with rec._lock:
        start = time.monotonic()
        path = rec.crash_dump(str(tmp_path / "dump.jsonl"))
        elapsed = time.monotonic() - start
    assert elapsed < 2.0
    steps = [json.loads(line)["fields"]["step"] for line in open(path) if line.strip()]
    assert steps == list(range(2, 10))  # the ring's 8 newest, oldest first


def test_ring_helpers_match_the_reference():
    _need_ref()
    out = []
    for mod in (ref_flight, port_flight):
        rec = mod.FlightRecorder(capacity=4, clock=FakeClock().monotonic)
        for i in range(6):
            rec.record("serve", corr="c", op="step", step=i)
        lines = [json.loads(line) for line in rec.to_jsonl(kind="serve").splitlines()]
        for line in lines:
            del line["wall"]
        out.append((len(rec), lines, rec.to_jsonl(corr="none")))
    assert out[1] == out[0]
    assert out[1][0] == 4 and [r["fields"]["step"] for r in out[1][1]] == [2, 3, 4, 5]


def test_write_signal_snapshot_does_not_block_its_caller(tmp_path):
    prof = port_profiler.SamplingProfiler(hz=200)
    stop = threading.Event()
    worker = threading.Thread(target=lambda: stop.wait(10), name="decode-engine-park",
                              daemon=True)
    worker.start()
    try:
        before = time.monotonic()
        path = port_profiler.write_signal_snapshot(str(tmp_path), seconds=0.05, hz=200,
                                                   profiler=prof)
        assert time.monotonic() - before < 0.1
        assert os.path.basename(path) == f"profile-usr2-{os.getpid()}.json"
        deadline = time.monotonic() + 5
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
        with open(path) as handle:
            payload = json.load(handle)
    finally:
        stop.set()
        worker.join(5)
    assert payload["profile"] == "tf-operator-tpu-sampling"
    assert payload["samples"] > 0
    assert any(stack.startswith("engine;") for stack in payload["folded"])


def test_profile_chrome_events_match_the_reference():
    _need_ref()
    from tf_operator_tpu.telemetry.profiler import profile_chrome_events as ref_events

    payload = _payload(1)
    events = port_profiler.profile_chrome_events(payload)
    assert events == ref_events(payload)
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names <= {"profile:engine", "profile:server", "profile:main"}
    assert sum(e["args"]["count"] for e in events if e["ph"] == "i") == payload["samples"]


_CHILD = textwrap.dedent("""
    import os, signal, sys, threading, time
    sys.path.insert(0, {repo!r})
    from tf_operator_tpu_torch.telemetry import flight, install_crash_handlers

    directory = sys.argv[1]
    stop = threading.Event()

    def engine():
        n = 0
        while not stop.is_set():
            with flight.correlate("req-%d" % (n % 3)):
                flight.flight_record("serve", op="step", step=n)
            n += 1
            time.sleep(0.001)

    thread = threading.Thread(target=engine, name="decode-engine", daemon=True)
    thread.start()
    handles = install_crash_handlers(directory=directory)
    time.sleep(0.2)
    os.kill(os.getpid(), signal.SIGUSR2)
    profile = os.path.join(directory, "profile-usr2-%d.json" % os.getpid())
    deadline = time.monotonic() + 20
    while not os.path.exists(profile) and time.monotonic() < deadline:
        time.sleep(0.05)
    print(len(handles.dumps), flush=True)
    raise RuntimeError("planted crash")
""")


def test_sigusr2_then_a_crash_in_a_child_and_both_clis_merge_the_dumps(tmp_path):
    """install_crash_handlers in a child: SIGUSR2 while an engine-named
    thread records writes the usr2 dump, the all-thread stacks (naming
    that thread) and, after the 5 s window, the profile; then a planted
    unhandled exception writes the crash dump and the child exits 1. The
    dumps merge through both CLIs with equal output, Perfetto included."""
    _need_ref()
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO), str(tmp_path)],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stderr
    assert "RuntimeError: planted crash" in proc.stderr
    assert proc.stdout.split() == ["3"]
    pid = re.search(r"flight-crash-(\d+)\.jsonl", proc.stderr).group(1)
    names = sorted(os.listdir(tmp_path))
    assert names == [f"flight-crash-{pid}.jsonl", f"flight-stacks-{pid}.txt",
                     f"flight-usr2-{pid}.jsonl", f"profile-usr2-{pid}.json"]
    stacks = (tmp_path / f"flight-stacks-{pid}.txt").read_text()
    assert "engine" in stacks and "File" in stacks
    usr2 = [json.loads(line) for line in open(tmp_path / f"flight-usr2-{pid}.jsonl")]
    assert {r["corr"] for r in usr2} >= {"req-0", "req-1", "req-2"}
    crash = [json.loads(line) for line in open(tmp_path / f"flight-crash-{pid}.jsonl")]
    assert crash[-1]["fields"]["step"] > usr2[-1]["fields"]["step"]
    profile = json.loads((tmp_path / f"profile-usr2-{pid}.json").read_text())
    assert profile["samples"] > 0 and any(s.startswith("engine;") for s in profile["folded"])
    dumps = [str(tmp_path / f"flight-usr2-{pid}.jsonl"),
             str(tmp_path / f"flight-crash-{pid}.jsonl")]
    (ref, port), dirs = _both(
        lambda out: [*dumps, "--corr", "req-1", "--limit", "20", "--perfetto",
                     os.path.join(out, "merged.json")], tmp_path)
    assert port == ref and port[0] == 0
    assert "# 20 records, 1 correlation IDs, 2 dump(s)" in port[1]
    _files_equal(dirs)
    (ref, port), _ = _both(
        lambda out: ["profile", "--input", str(tmp_path / f"profile-usr2-{pid}.json"),
                     "--top", "10"], tmp_path)
    assert port == ref and port[0] == 0 and "engine" in port[1]


# -- operator_rules ----------------------------------------------------------------

def _operator_script(alerts, history, flight, clock_mod, registry_mod):
    clock = clock_mod.FakeClock()
    hist = history.MetricHistory(capacity=256, clock=clock)
    manager = alerts.AlertManager(hist, alerts.operator_rules(),
                                  registry=registry_mod.MetricRegistry("op"), clock=clock,
                                  flight=flight.FlightRecorder())
    transitions, firing = [], []
    counts = {"leader": 0.0, "fence": 0.0}
    for n, leader_rate, fence_rate, degraded, depth in (
            (10, 0, 0, 0, 10), (12, 4, 0, 1, 150), (6, 4, 1, 1, 150), (30, 0, 0, 0, 40),
            (40, 0, 0, 0, 40)):
        for _ in range(n):
            clock.advance(10.0)
            counts["leader"] += leader_rate
            counts["fence"] += fence_rate
            hist.ingest_value("tf_operator_tpu_leader_transitions_total", "counter",
                              counts["leader"])
            hist.ingest_value("fence_rejections_total", "counter", counts["fence"])
            hist.ingest_value("tf_operator_tpu_degraded", "gauge", float(degraded))
            hist.ingest_value('tf_operator_tpu_workqueue_depth{name="tfjob"}', "gauge",
                              float(depth))
            transitions.append(manager.evaluate())
        firing.append(manager.firing())
    page = json.loads(alerts.render_alertz(manager, ""))
    return {"transitions": transitions, "firing": firing, "page": page,
            "rules": [(type(r).__name__, r.name, r.series, r.description)
                      for r in alerts.operator_rules(prefix="x")]}


def test_operator_rules_transitions_match_the_reference():
    _need_ref()
    from tf_operator_tpu.telemetry import registry as ref_registry
    from tf_operator_tpu_torch.controller import clock as port_clock
    from tf_operator_tpu_torch.telemetry import registry as port_registry

    ref = _operator_script(ref_alerts, ref_history, ref_flight, ref_clock, ref_registry)
    port = _operator_script(port_alerts, port_history, port_flight, port_clock, port_registry)
    assert port == ref
    assert port["firing"][0] == []
    assert set(port["firing"][2]) == {"leader-churn", "fence-rejections", "degraded-latch",
                                      "workqueue-depth"}
    assert port["firing"][-1] == []
    assert sum(len(t) for t in port["transitions"]) == 8


def test_the_exports_equal_the_reference():
    _need_ref()
    assert sorted(port_telemetry.__all__) == sorted(ref_telemetry.__all__)
    assert port_telemetry.WORKQUEUE_BUCKETS == ref_telemetry.WORKQUEUE_BUCKETS
    assert sorted(port_flight.__all__) == sorted(ref_flight.__all__)
    for name in ("install_crash_handlers", "CrashHandles", "all_thread_stacks",
                 "flight_chrome_events", "_dump_dir"):
        assert callable(getattr(port_flight, name))
    assert callable(port_flight.FlightRecorder.crash_dump)


def test_dump_dir_follows_the_environment(monkeypatch, tmp_path):
    """Without a directory the dumps go to $TF_OPERATOR_FLIGHT_DIR."""
    monkeypatch.setenv("TF_OPERATOR_FLIGHT_DIR", str(tmp_path))
    assert port_flight._dump_dir() == str(tmp_path)
    rec = port_flight.FlightRecorder(capacity=4)
    rec.record("serve", op="step")
    prev_hook = sys.excepthook
    sys.excepthook = lambda *a: None
    try:
        handles = port_flight.install_crash_handlers(recorder=rec, install_signal=False)
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                sys.excepthook(RuntimeError, RuntimeError("x"), None)
        finally:
            handles.uninstall()
    finally:
        sys.excepthook = prev_hook
    assert handles.dumps == [str(tmp_path / f"flight-crash-{os.getpid()}.jsonl")]
    assert json.loads(open(handles.dumps[0]).read())["fields"]["op"] == "step"


# -- serve --smoke -----------------------------------------------------------------

def _report(stdout):
    return json.loads(stdout[stdout.index("{"):])


def test_serve_smoke_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "tf_operator_tpu_torch.serve", "--smoke",
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = _report(proc.stdout)
    assert report["ok"] is True
    assert report["streamed_tokens"] == 8 and report["batch_chains"] == 2
    assert {"queued", "admitted", "first-token"} <= set(report["span_marks"])
    assert {"request", "submit", "admit", "evict", "first-token"} <= \
        set(report["flight_request_ops"])
    assert proc.stdout.startswith("wrote ")  # the CLI's round trip, as in the reference


def test_serve_smoke_report_keys_equal_the_reference():
    _need_ref()
    from tf_operator_tpu.serve import server as ref_server

    reports = []
    for smoke in (ref_server._smoke, lambda: torch_server._smoke("cpu")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = smoke()
        reports.append((rc, _report(out.getvalue())))
    (ref_rc, ref), (port_rc, port) = reports
    assert sorted(port) == sorted(ref)
    assert ref_rc == port_rc == 0 and ref["ok"] and port["ok"]
    assert port["streamed_tokens"] == ref["streamed_tokens"]
    assert port["batch_chains"] == ref["batch_chains"]
    assert set(ref["flight_request_ops"]) <= set(port["flight_request_ops"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a host without a card")
def test_serve_smoke_without_a_card_names_cuda():
    proc = subprocess.run([sys.executable, "-m", "tf_operator_tpu_torch.serve", "--smoke"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError: CUDA is not available" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_serve_cli_takes_smoke_and_still_refuses_the_rest(capsys):
    args = torch_server.parse_args(["--smoke", "--device", "cpu"])
    assert args.smoke is True and args.device == "cpu"
    with pytest.raises(SystemExit) as err:
        torch_server.parse_args(["--warm", "1"])
    assert err.value.code == 2
    assert "--warm" in capsys.readouterr().err


def test_no_signal_or_hook_is_left_installed(tmp_path):
    before = (sys.excepthook, signal.getsignal(signal.SIGUSR2))
    handles = port_flight.install_crash_handlers(directory=str(tmp_path))
    assert sys.excepthook is not before[0]
    assert signal.getsignal(signal.SIGUSR2) is not before[1]
    handles.uninstall()
    assert (sys.excepthook, signal.getsignal(signal.SIGUSR2)) == before


# -- the fleet smokes' observatory hooks, as chip_smoke.py's fleet phases use them --

def test_autoscale_smoke_alertz_fires_then_resolves_in_both_clis():
    """run_autoscale_smoke(observe=True) with on_observatory: at the
    scaled-out point `alertz --observatory` exits 3 in both CLIs (the
    smoke's ttft-slo rule, which the observatory carries, fires), after the
    scale-in 0; kvz and historyz print the same pages in both."""
    _need_ref()
    from tf_operator_tpu_torch.serve import fleet as torch_fleet

    seen = {}

    def on_observatory(url, stage):
        proxy = _Replay(url)
        try:
            forms = [["alertz", "--observatory", proxy.url]]
            if stage == "fired":
                forms += [["kvz", "--observatory", proxy.url],
                          ["historyz", "--observatory", proxy.url, "--window", "60"]]
            seen[stage] = [_live_both(argv) for argv in forms]
        finally:
            proxy.close()

    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    summary = torch_fleet.run_autoscale_smoke(seed=0, cfg=cfg, device="cpu", observe=True,
                                              on_observatory=on_observatory)
    assert summary["ok"], summary["problems"]
    assert sorted(seen) == ["fired", "resolved"]
    for stage, runs in seen.items():
        for ref, port in runs:
            assert port == ref
    fired, resolved = seen["fired"][0][1], seen["resolved"][0][1]
    assert fired[0] == 3 and "ttft-slo" in fired[1]
    assert resolved[0] == 0 and "# firing fleet-wide: (none)" in resolved[1]
    assert all(port[0] == 0 for _, port in seen["fired"][1:])


def test_trace_smoke_tracez_prints_the_pages_hops_in_both_clis():
    _need_ref()
    from tf_operator_tpu_torch.serve import fleet as torch_fleet

    seen = {}

    def on_observatory(url, traces):
        proxy = _Replay(url)
        try:
            for trace in traces:
                seen[trace] = _live_both(["tracez", "--trace", trace, "--observatory",
                                          proxy.url])
        finally:
            proxy.close()

    cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
    try:
        summary = torch_fleet.run_trace_smoke(seed=0, cfg=cfg, device="cpu",
                                              on_observatory=on_observatory)
        breakdowns = summary["breakdowns"]
    except AssertionError as err:  # the coverage bound is test_torch_fleet.py's
        breakdowns = json.loads(str(err).split(": ", 1)[1])["breakdowns"]
    assert sorted(seen) == sorted(breakdowns)
    migrated = 0
    for trace, (ref, port) in seen.items():
        assert port == ref and port[0] == 0
        names = [line.split()[0] for line in port[1].splitlines() if not line.startswith("#")]
        assert names == [h["name"] for h in breakdowns[trace]["hops"]]
        migrated += names == list(HOP_NAMES)
    assert migrated >= 1
