"""Training-plane observability: the port's copy of
tf_operator_tpu/train/observe.py.

- `StepPhaseTimer` laps each step of `Trainer.fit` into
  data_wait -> host_to_device -> step_dispatch -> device_sync ->
  checkpoint -> eval_publish, observed into the labeled
  ``train_step_phase_seconds{phase=}`` histogram, plus one
  ``kind="trainstep"`` flight record every N steps with the split.
- `GoodputLedger` keeps monotone counters of useful against wasted
  step-seconds (warm-up, re-warm-up after a restart, checkpoint save and
  restore, the preemption-lost tail); its integer step buckets reconcile
  exactly with the step counter.
- `HealthPhase` holds the lifecycle phase (warming -> training ->
  checkpointing -> preempted).
- `TrainTelemetry`: the per-worker telemetry server every train CLI
  starts with ``--monitoring-bind-addr``: /metrics, /healthz (the
  phase), /debug/slozz (the goodput ledger and the phase split),
  /debug/flightz, /debug/historyz, /debug/alertz and /debug/profilez.
- `TrainFleetView` scrapes every worker of a TFJob, computes each
  worker's step-rate skew against the fleet median and feeds the
  `train_rules` alert pack (stragglers below 0.7x the median rate,
  stalls of K median step times). `fold_train_observability` folds its
  summary into TFJob status.extra.
- `run_train_observe_smoke`: two MNIST workers in threads of one
  process, a latency fault on one worker's input fires
  train-straggler, the fault clears and the alert resolves
  (``python -m tf_operator_tpu_torch.train.observe --smoke``).

Timing goes through the Clock.monotonic seam (controller/clock.py), so
FakeClock drives the timer, the ledger and the stall detector in tests.
"""

from __future__ import annotations

import contextlib
import json
import logging
import statistics
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Optional
from urllib.request import urlopen

from ..controller.clock import Clock
from ..telemetry import (
    STEP_BUCKETS,
    MetricHistory,
    MetricRegistry,
    default_registry,
    render_alertz,
    render_historyz,
)
from ..telemetry.alerts import AlertManager, train_rules
from ..telemetry.flight import default_flight, flight_record, render_flightz
from ..telemetry.profiler import default_profiler, render_profilez
from ..utils import locks

logger = logging.getLogger("tf_operator_tpu_torch.train.observe")

__all__ = [
    "PHASES", "WASTE_REASONS", "StepPhaseTimer", "GoodputLedger", "HealthPhase",
    "TrainTelemetry", "WorkerClient", "TrainFleetView", "fold_train_observability",
    "run_train_observe_smoke", "add_monitoring_flag", "telemetry_server",
]

# the six step phases, in loop order; everything else is residual
PHASES = (
    "data_wait",        # next(batches): host input pipeline
    "host_to_device",   # place_batch: prepare + device_put
    "step_dispatch",    # the step call (eager dispatch)
    "device_sync",      # blocking on device results (drains, float())
    "checkpoint",       # async save dispatch / blocking save
    "eval_publish",     # metrics callbacks, summaries, logging
)

WASTE_REASONS = ("warmup", "rewarmup", "checkpoint", "restore", "preempted")

# the observe smoke's input pace per batch through its three phases
SMOKE_STEP_PACE_S = 0.05

# prefixed series names the fleet view ingests and train_rules watch
STEPS_SERIES = "tf_operator_tpu_train_steps_total"
SLOWDOWN_SERIES = "tf_operator_tpu_train_fleet_worker_slowdown"
STALL_SERIES = "tf_operator_tpu_train_fleet_worker_stall_ratio"


class StepPhaseTimer:
    """Laps one training step into the six PHASES.

    Per step: `start()`, then `lap(phase)` after each phase's code
    (contiguous laps, so attribution gaps are only the un-lapped
    residual), then `finish(step)` to observe the histogram children
    and — every `flight_every` steps — emit ONE kind="trainstep"
    flight record with the split. The timer measures its own
    bookkeeping (`overhead_fraction()`) so the <2% attribution-
    overhead budget is asserted, not assumed."""

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        clock: Optional[Clock] = None,
        flight_every: int = 50,
    ) -> None:
        registry = registry if registry is not None else default_registry()
        self.clock = clock if clock is not None else Clock()
        self.flight_every = max(1, int(flight_every))
        self._h = registry.histogram(
            "train_step_phase_seconds",
            "Per-step wall seconds attributed to each loop phase "
            "(data_wait|host_to_device|step_dispatch|device_sync|"
            "checkpoint|eval_publish)",
            buckets=STEP_BUCKETS,
            labelnames=("phase",),
        )
        self._children = {p: self._h.labels(phase=p) for p in PHASES}
        # cumulative totals (floats under the step loop's thread; a
        # reader sees at worst a slightly stale split)
        self.steps = 0
        self.wall_seconds = 0.0
        self.attributed_seconds = 0.0
        self.overhead_seconds = 0.0
        self.phase_seconds: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._t0: Optional[float] = None
        self._last = 0.0
        self._laps: Dict[str, float] = {}

    def start(self) -> None:
        self._t0 = self._last = self.clock.monotonic()
        self._laps = {}

    def lap(self, phase: str) -> float:
        """Attribute the interval since the previous lap (or start)
        to `phase`; -> the lap seconds."""
        now = self.clock.monotonic()
        dur = now - self._last
        self._last = now
        self._laps[phase] = self._laps.get(phase, 0.0) + dur
        # the cost of the bookkeeping itself (two clock reads + a dict
        # update) — it rides inside the *next* phase's interval, so
        # accumulate it separately for the overhead bound
        self.overhead_seconds += self.clock.monotonic() - now
        return dur

    def finish(self, step: int) -> Dict[str, float]:
        """Close the step: observe each phase's lap, roll totals, and
        emit the periodic trainstep flight record. -> the step's
        {phase: seconds} split plus "wall"."""
        if self._t0 is None:
            return {}
        now = self.clock.monotonic()
        wall = max(now - self._t0, 0.0)
        attributed = 0.0
        for phase, seconds in self._laps.items():
            child = self._children.get(phase)
            if child is not None:
                child.observe(seconds)
            self.phase_seconds[phase] = (
                self.phase_seconds.get(phase, 0.0) + seconds
            )
            attributed += seconds
        self.steps += 1
        self.wall_seconds += wall
        self.attributed_seconds += attributed
        split = dict(self._laps)
        split["wall"] = wall
        if self.steps % self.flight_every == 0:
            flight_record(
                "trainstep",
                step=int(step),
                wall=round(wall, 6),
                coverage=round(attributed / wall, 4) if wall > 0 else 1.0,
                **{p: round(s, 6) for p, s in self._laps.items()},
            )
        self._t0 = None
        return split

    def coverage(self) -> float:
        """Fraction of cumulative step wall attributed to a named
        phase (1.0 before any step — nothing unattributed yet)."""
        if self.wall_seconds <= 0:
            return 1.0
        return min(self.attributed_seconds / self.wall_seconds, 1.0)

    def overhead_fraction(self) -> float:
        """Timer bookkeeping seconds / step wall — the attribution
        overhead, budgeted under 2% of the step wall."""
        if self.wall_seconds <= 0:
            return 0.0
        return self.overhead_seconds / self.wall_seconds

    def summary(self) -> Dict:
        return {
            "steps": self.steps,
            "wall_seconds": round(self.wall_seconds, 6),
            "coverage": round(self.coverage(), 4),
            "overhead_fraction": round(self.overhead_fraction(), 6),
            "phase_seconds": {
                p: round(s, 6) for p, s in self.phase_seconds.items()
            },
        }


class GoodputLedger:
    """Monotone useful-vs-wasted accounting for a training process.

    Seconds: `useful(dt)` for productive step wall;
    `waste(reason, dt)` for warmup/rewarmup compile, checkpoint
    save, restore, and the preemption-lost tail since the last
    checkpoint. goodput_fraction = useful / (useful + wasted).

    Steps (the EXACT reconciliation): every executed optimizer step is
    attributed to exactly one integer bucket — useful, warmup, or
    rewarmup — so `accounted_steps()` must equal the step counter.
    Preemption-lost steps are recorded under the "preempted" step
    counter as re-work (they were executed, then lost); counters are
    monotone, so they are NOT subtracted from useful."""

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
    ) -> None:
        registry = registry if registry is not None else default_registry()
        self._c_useful = registry.counter(
            "train_goodput_useful_seconds_total",
            "Step wall seconds that advanced training (excludes "
            "warmup compile, checkpoint I/O, and preemption-lost tail)",
        )
        self._c_wasted = registry.counter(
            "train_goodput_wasted_seconds_total",
            "Step wall seconds that did NOT advance training, by reason",
            labelnames=("reason",),
        )
        self._c_useful_steps = registry.counter(
            "train_goodput_useful_steps_total",
            "Optimizer steps attributed as useful",
        )
        self._c_wasted_steps = registry.counter(
            "train_goodput_wasted_steps_total",
            "Optimizer steps attributed as waste (warmup/rewarmup "
            "compile steps; preempted = executed-then-lost re-work)",
            labelnames=("reason",),
        )
        self._g_fraction = registry.gauge(
            "train_goodput_fraction",
            "useful_seconds / (useful_seconds + wasted_seconds)",
        )
        self._lock = locks.make_lock("GoodputLedger._lock")
        self.useful_seconds = 0.0
        self.useful_steps = 0
        self.wasted: Dict[str, List[float]] = {
            r: [0.0, 0] for r in WASTE_REASONS
        }

    def useful(self, seconds: float, steps: int = 1) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            self.useful_seconds += seconds
            self.useful_steps += steps
        self._c_useful.inc(seconds)
        if steps:
            self._c_useful_steps.inc(steps)
        self._g_fraction.set(self.fraction())

    def waste(self, reason: str, seconds: float, steps: int = 0) -> None:
        if reason not in self.wasted:
            raise ValueError(
                f"unknown waste reason {reason!r} (have {WASTE_REASONS})"
            )
        seconds = max(0.0, float(seconds))
        with self._lock:
            entry = self.wasted[reason]
            entry[0] += seconds
            entry[1] += steps
        self._c_wasted.labels(reason=reason).inc(seconds)
        if steps:
            self._c_wasted_steps.labels(reason=reason).inc(steps)
        self._g_fraction.set(self.fraction())

    def wasted_seconds(self) -> float:
        with self._lock:
            return sum(entry[0] for entry in self.wasted.values())

    def fraction(self) -> float:
        """Goodput: useful / (useful + wasted) seconds; 1.0 with no
        activity yet (an idle process has wasted nothing)."""
        with self._lock:
            wasted = sum(entry[0] for entry in self.wasted.values())
            total = self.useful_seconds + wasted
            return 1.0 if total <= 0 else self.useful_seconds / total

    def accounted_steps(self) -> int:
        """useful + warmup + rewarmup steps — the buckets every
        executed step lands in exactly once; must equal the step
        counter."""
        with self._lock:
            return (
                self.useful_steps
                + self.wasted["warmup"][1]
                + self.wasted["rewarmup"][1]
            )

    def reconciles(self, executed_steps: int) -> bool:
        return self.accounted_steps() == int(executed_steps)

    def snapshot(self) -> Dict:
        with self._lock:
            wasted = {
                r: {"seconds": round(e[0], 6), "steps": e[1]}
                for r, e in self.wasted.items()
            }
            useful_seconds = self.useful_seconds
            useful_steps = self.useful_steps
        return {
            "useful_seconds": round(useful_seconds, 6),
            "useful_steps": useful_steps,
            "wasted": wasted,
            "accounted_steps": self.accounted_steps(),
            "goodput_fraction": round(self.fraction(), 6),
        }


class HealthPhase:
    """Tiny thread-safe holder for the trainer's lifecycle phase
    (warming -> training -> checkpointing -> preempted) — what
    a worker's health page reports. No transition matrix: the loop is the state
    machine; this only publishes it."""

    PHASES = ("warming", "training", "checkpointing", "preempted")

    def __init__(self) -> None:
        self._lock = locks.make_lock("HealthPhase._lock")
        self._phase = "warming"

    def set(self, phase: str) -> None:
        if phase not in self.PHASES:
            raise ValueError(f"unknown phase {phase!r} (have {self.PHASES})")
        with self._lock:
            self._phase = phase

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase


# -- the worker telemetry server -----------------------------------------------

class TrainTelemetry:
    """The per-worker trainer telemetry bundle and its HTTP server:

        telemetry = TrainTelemetry(trainer=trainer, worker="worker-0")
        port = telemetry.start("0.0.0.0:9090")
        ...
        telemetry.stop()

    Serves /metrics, /healthz (the trainer's lifecycle phase),
    /debug/flightz, /debug/historyz, /debug/alertz, /debug/profilez and
    /debug/slozz (the goodput ledger and the phase split). History
    sampling rides a background tick thread; alerts default to an empty
    local rule set (the fleet-level rules live in TrainFleetView).
    `stop()` ends the listener and the tick thread."""

    def __init__(
        self,
        trainer=None,
        worker: str = "worker-0",
        registry: Optional[MetricRegistry] = None,
        clock: Optional[Clock] = None,
        rules: Optional[List] = None,
        history_capacity: int = 512,
        history_interval_s: float = 2.0,
        fleet_view: Optional["TrainFleetView"] = None,
    ) -> None:
        # with a TrainFleetView attached, /debug/slozz also carries its
        # newest report as the "train_fleet" block
        self.fleet_view = fleet_view
        if registry is None:
            registry = trainer.metrics_registry if trainer is not None else default_registry()
        self.trainer = trainer
        self.worker = worker
        self.registry = registry
        self.clock = clock if clock is not None else Clock()
        self.history = MetricHistory(capacity=history_capacity, clock=self.clock)
        self.history.track_registry(registry)
        self.alerts = AlertManager(
            self.history, rules or [], registry=registry, clock=self.clock,
            flight=default_flight(),
        )
        self._history_interval_s = history_interval_s
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None

    # -- pages --------------------------------------------------------------

    def healthz(self) -> Dict:
        health = getattr(self.trainer, "health", None)
        body = {"ok": True, "phase": health.phase if health is not None else "warming",
                "worker": self.worker}
        timer = getattr(self.trainer, "phase_timer", None)
        if timer is not None:
            body["steps"] = timer.steps
        return body

    def slozz(self) -> Dict:
        """The worker's SLO block: the goodput ledger and the phase split."""
        block: Dict = {"worker": self.worker, "healthz": self.healthz()}
        ledger = getattr(self.trainer, "goodput", None)
        timer = getattr(self.trainer, "phase_timer", None)
        if ledger is not None:
            block["goodput"] = ledger.snapshot()
            block["goodput_fraction"] = block["goodput"]["goodput_fraction"]
        if timer is not None:
            block["phases"] = timer.summary()
        doc = {"train": block}
        if self.fleet_view is not None:
            doc["train_fleet"] = self.fleet_view.last_report or {}
        return doc

    def page(self, path: str, query: str = ""):
        """-> (content type, body) of one route, or None for an unknown
        one."""
        if path == "/metrics":
            return "text/plain; version=0.0.4", self.registry.render().encode()
        if path == "/healthz":
            return "application/json", json.dumps(self.healthz()).encode()
        if path == "/debug/slozz":
            return "application/json", json.dumps(self.slozz()).encode()
        if path == "/debug/flightz":
            return "application/x-ndjson", render_flightz(default_flight(), query)
        if path == "/debug/historyz":
            return "application/json", render_historyz(self.history, query)
        if path == "/debug/alertz":
            return "application/json", render_alertz(self.alerts, query)
        if path == "/debug/profilez":
            # resolved per request, so a profiler swapped in later is the
            # one served
            return render_profilez(default_profiler(), query)
        return None

    # -- server -------------------------------------------------------------

    def start(self, bind_addr: str = "127.0.0.1:0") -> int:
        host, _, port_s = bind_addr.rpartition(":")
        host = host or "127.0.0.1"
        telemetry = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path, _, query = self.path.partition("?")
                try:
                    page = telemetry.page(path, query)
                except Exception as err:  # noqa: BLE001 (a debug page degrades to 500)
                    self.send_error(500, str(err))
                    return
                if page is None:
                    self.send_error(404)
                    return
                ctype, body = page
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass

        self._httpd = ThreadingHTTPServer((host, int(port_s or 0)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"train-telemetry-{self.worker}", daemon=True,
        )
        self._thread.start()
        if self._history_interval_s > 0:
            self.history.start(interval_s=self._history_interval_s)
        logger.info("trainer telemetry for %s on %s:%d", self.worker, host, self.port)
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.history.stop()


def add_monitoring_flag(parser, plane: str = "trainer") -> None:
    """--monitoring-bind-addr, as every train CLI of the reference takes it."""
    parser.add_argument(
        "--monitoring-bind-addr", default=None,
        help=f"host:port for the {plane} telemetry server (/metrics, /healthz, /debug/* "
        "— train/observe.py)",
    )


@contextlib.contextmanager
def telemetry_server(
    trainer, bind_addr: Optional[str], worker: Optional[str] = None,
) -> Iterator[Optional[TrainTelemetry]]:
    """The train CLIs' --monitoring-bind-addr: a TrainTelemetry for this
    process (`worker`, by default worker-<rank>) serving on bind_addr for
    the block, stopped on the way out; nothing when bind_addr is empty."""
    if not bind_addr:
        yield None
        return
    if worker is None:
        from ..parallel import distributed

        worker = f"worker-{distributed.rank()}"
    telemetry = TrainTelemetry(trainer=trainer, worker=worker)
    telemetry.start(bind_addr)
    try:
        yield telemetry
    finally:
        telemetry.stop()


# -- fleet view ----------------------------------------------------------------

class WorkerClient:
    """Minimal scrape client for one worker's telemetry port."""

    def __init__(self, base_url: str, timeout: float = 5.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> bytes:
        with urlopen(self.base_url + path, timeout=self.timeout) as resp:
            return resp.read()

    def metrics(self) -> Dict[str, float]:
        """Flat {sample name with labels: value} from /metrics."""
        out: Dict[str, float] = {}
        for line in self._get("/metrics").decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.split()
                out[name] = float(value)
        return out

    def healthz(self) -> Dict:
        return json.loads(self._get("/healthz"))

    def slozz(self) -> Dict:
        return json.loads(self._get("/debug/slozz"))


class TrainFleetView:
    """Scrapes every worker of a TFJob and turns raw step counters into
    the skew and stall series the train_rules alert pack watches.

    Per observe() pass:

    - scrape each worker's /metrics; a failed scrape marks the pass
      partial (alerts hold their firing state rather than resolve on a
      dead scrape);
    - ingest each worker's ``train_steps_total`` into the fleet history
      and compute its step rate over `rate_window_s`;
    - slowdown_w = fleet median rate / worker rate (a straggler at 0.7x
      the median reads ~1.43) -> ``..worker_slowdown{worker=}``;
    - stall_ratio_w = seconds since the worker's counter last moved /
      the fleet median step time -> ``..worker_stall_ratio{worker=}``;
    - evaluate the alert manager with the pass's partial flag.
    """

    # a dead worker's rate is 0; cap the ratio so JSON stays finite
    MAX_SLOWDOWN = 1e3

    def __init__(
        self,
        workers: Dict[str, WorkerClient],
        history: Optional[MetricHistory] = None,
        alerts: Optional[AlertManager] = None,
        registry: Optional[MetricRegistry] = None,
        clock: Optional[Clock] = None,
        rate_window_s: float = 6.0,
        straggler_ratio: float = 0.7,
        stall_k: float = 8.0,
    ) -> None:
        self.workers = dict(workers)
        self.clock = clock if clock is not None else Clock()
        self.history = (
            history if history is not None else MetricHistory(capacity=1024, clock=self.clock)
        )
        self.registry = registry if registry is not None else MetricRegistry("tf_operator_tpu")
        self.alerts = alerts
        self.rate_window_s = rate_window_s
        self.straggler_ratio = straggler_ratio
        self.stall_k = stall_k
        self._g_slowdown = self.registry.gauge(
            "train_fleet_worker_slowdown",
            "fleet median step rate / this worker's step rate "
            "(straggler when > 1/straggler_ratio)",
            labelnames=("worker",),
        )
        self._g_stall = self.registry.gauge(
            "train_fleet_worker_stall_ratio",
            "seconds since this worker's step counter moved, in units of the fleet "
            "median step time",
            labelnames=("worker",),
        )
        self._g_rate = self.registry.gauge(
            "train_fleet_worker_steps_per_sec",
            "per-worker step rate over the fleet view's window",
            labelnames=("worker",),
        )
        self._g_last_step = self.registry.gauge(
            "train_fleet_last_step", "max step counter observed across the fleet",
        )
        # worker -> [last step count, monotonic time it last moved]
        self._progress: Dict[str, List[float]] = {}
        # the newest observe() report (the "train_fleet" slozz block)
        self.last_report: Optional[Dict] = None

    def observe(self) -> Dict:
        now = self.clock.monotonic()
        counts: Dict[str, float] = {}
        phases: Dict[str, str] = {}
        scrape_errors: Dict[str, str] = {}
        for name, client in self.workers.items():
            try:
                flat = client.metrics()
            except Exception as err:  # noqa: BLE001 (a dead worker makes the pass partial)
                scrape_errors[name] = str(err)
                continue
            counts[name] = flat.get(STEPS_SERIES, 0.0)
            try:
                phases[name] = client.healthz().get("phase", "")
            except Exception:  # noqa: BLE001
                phases[name] = ""
        partial = bool(scrape_errors)

        rates: Dict[str, Optional[float]] = {}
        for name, count in counts.items():
            series = f'{STEPS_SERIES}{{worker="{name}"}}'
            self.history.ingest_value(series, "counter", count)
            rates[name] = self.history.rate(series, self.rate_window_s)
            last = self._progress.get(name)
            if last is None or count > last[0]:
                self._progress[name] = [count, now]

        present = [r for r in rates.values() if r is not None]
        median_rate = statistics.median(present) if present else None
        median_step_time = 1.0 / median_rate if median_rate and median_rate > 0 else None

        report_workers: Dict[str, Dict] = {}
        stragglers: List[str] = []
        stalled: List[str] = []
        for name, count in counts.items():
            rate = rates.get(name)
            slowdown = None
            if median_rate is not None and rate is not None:
                if median_rate <= 0:
                    slowdown = 1.0  # an idle fleet has no stragglers
                elif rate <= 0:
                    slowdown = self.MAX_SLOWDOWN
                else:
                    slowdown = min(median_rate / rate, self.MAX_SLOWDOWN)
            stall_ratio = None
            if median_step_time is not None and name in self._progress:
                idle = now - self._progress[name][1]
                stall_ratio = idle / max(median_step_time, 1e-3)
            if slowdown is not None:
                self._g_slowdown.labels(worker=name).set(slowdown)
                self.history.ingest_value(f'{SLOWDOWN_SERIES}{{worker="{name}"}}', "gauge",
                                          slowdown)
                if slowdown > 1.0 / self.straggler_ratio:
                    stragglers.append(name)
            if stall_ratio is not None:
                self._g_stall.labels(worker=name).set(stall_ratio)
                self.history.ingest_value(f'{STALL_SERIES}{{worker="{name}"}}', "gauge",
                                          stall_ratio)
                if stall_ratio > self.stall_k:
                    stalled.append(name)
            if rate is not None:
                self._g_rate.labels(worker=name).set(rate)
            report_workers[name] = {
                "steps": int(count),
                "steps_per_sec": round(rate, 4) if rate is not None else None,
                "slowdown": round(slowdown, 4) if slowdown is not None else None,
                "stall_ratio": round(stall_ratio, 4) if stall_ratio is not None else None,
                "phase": phases.get(name, ""),
            }

        last_step = int(max(counts.values())) if counts else 0
        self._g_last_step.set(last_step)
        if self.alerts is not None:
            self.alerts.evaluate(partial=partial)

        report = {
            "workers": report_workers,
            "median_steps_per_sec": round(median_rate, 4) if median_rate is not None else None,
            "last_step": last_step,
            "stragglers": sorted(stragglers),
            "stalled": sorted(stalled),
            "partial": partial,
            "scrape_errors": scrape_errors,
        }
        if self.alerts is not None:
            report["alerts"] = {"firing": self.alerts.firing()}
        self.last_report = report
        return report


def fold_train_observability(job, report: Dict) -> None:
    """Fold the fleet view's summary into TFJob status.extra (duck-typed:
    any object with `status.extra`, a dict), the shape the operator
    publishes so that `kubectl get -o json` answers "is this job making
    progress" without scraping workers."""
    job.status.extra["trainObservability"] = {
        "lastStep": report.get("last_step", 0),
        "medianStepsPerSec": report.get("median_steps_per_sec"),
        "stragglers": list(report.get("stragglers", ())),
        "stalledWorkers": list(report.get("stalled", ())),
        "alertsFiring": list((report.get("alerts") or {}).get("firing", ())),
        "partial": bool(report.get("partial", False)),
    }


# -- the end-to-end smoke ----------------------------------------------------------

def run_train_observe_smoke(
    seed: int = 0,
    steps: int = 400,
    delay_s: float = 0.25,
    namespace: str = "train-observe",
    device=None,
) -> dict:
    """End-to-end proof of the training observatory: two Trainer workers
    train MNIST in threads of this process on `device` (cuda unless
    named), each serving its telemetry port; the fleet view scrapes both.
    Phase 1 (baseline) fires nothing; phase 2 adds `delay_s` to every
    batch of worker-1's input (a FAULT_LATENCY) until train-straggler
    fires; phase 3 clears the fault and waits for the resolve. Then the
    workers run out their `steps` budget at full speed.

    Both workers' inputs take SMOKE_STEP_PACE_S a batch through the
    three phases, so the arc's timing does not depend on how fast the
    device steps (the reference's 60 unpaced steps can end before the
    fault is injected on a fast device): at most 20 steps a second, so a
    budget of 400 outlasts 20 s of phases. The profiler's duty cycle
    is read while it still runs and bounded on a CUDA device only: on
    the CPU two training threads and the sampler share the interpreter
    lock, and the ratio measures the machine's load, not the sampler.

    Asserts: the fire and resolve transitions exist as kind="alert"
    flight records whose trace samples meet the slowed steps, phase
    attribution covers >= 95% of step wall on both workers, the goodput
    ledger reconciles exactly with the step counter, the attribution and
    the sampling profiler's overhead each stay under 2% of step time (the
    profiler's on a CUDA device), the status fold round-trips through JSON, and both workers' pages
    rendered. Raises AssertionError on any violation; -> the summary."""
    import time
    import types

    import torch

    from .._device import resolve_device
    from ..chaos.faults import FAULT_LATENCY, FaultLog
    from ..models import mnist as mnist_lib
    from ..telemetry.profiler import SamplingProfiler
    from ..telemetry.tracecontext import trace_scope
    from .trainer import Trainer, classification_task

    device = resolve_device(device)
    clock = Clock()
    flight = default_flight()
    fault_log = FaultLog(flight=flight, seed=seed)
    started = clock.monotonic()

    # per-worker input latency, toggled between the phases below
    injected_delay = {"worker-1": 0.0}
    pace = {"s": SMOKE_STEP_PACE_S}
    slow_traces: List[str] = []

    def make_batches(worker: str, batch_size: int = 16):
        generator = torch.Generator().manual_seed(seed)
        while True:
            # a fresh trace per step: the contextvar set here is the
            # consuming step's ambient trace, so its flight records sample it
            with trace_scope() as ctx:
                delay = injected_delay.get(worker, 0.0)
                if delay > 0:
                    fault_log.append(f"{worker}-input", FAULT_LATENCY,
                                     detail=f"+{delay}s data_wait")
                    slow_traces.append(ctx.trace_id)
                if delay + pace["s"] > 0:
                    time.sleep(delay + pace["s"])
                yield mnist_lib.synthetic_batch(generator, batch_size)

    workers: Dict[str, Dict] = {}
    for idx in range(2):
        name = f"worker-{idx}"
        registry = MetricRegistry("tf_operator_tpu")
        trainer = Trainer(
            mnist_lib.MnistCNN(generator=torch.Generator().manual_seed(seed)),
            classification_task(), learning_rate=1e-3, weight_decay=0.0, device=device,
            metrics_registry=registry, clock=clock, phase_flight_every=5,
        )
        telemetry = TrainTelemetry(trainer=trainer, worker=name, registry=registry,
                                   clock=clock, history_interval_s=0.5)
        port = telemetry.start("127.0.0.1:0")
        workers[name] = {
            "trainer": trainer, "telemetry": telemetry,
            "client": WorkerClient(f"http://127.0.0.1:{port}"),
        }

    fleet_history = MetricHistory(capacity=2048, clock=clock)
    # the shape train_rules ships, at seconds instead of minutes
    manager = AlertManager(
        fleet_history,
        train_rules(sorted(workers), straggler_ratio=0.7, stall_k=8.0, for_s=0.0),
        flight=flight, clock=clock,
    )
    view = TrainFleetView({n: w["client"] for n, w in workers.items()}, history=fleet_history,
                          alerts=manager, clock=clock, rate_window_s=4.0)

    profiler = SamplingProfiler()
    profiler.start()
    threads = []
    fit_errors: List[str] = []

    def run_worker(name: str) -> None:
        w = workers[name]
        batches = make_batches(name)
        try:
            trainer = w["trainer"]
            w["state"], w["metrics"] = trainer.fit(trainer.init(), batches, steps=steps,
                                                   log_every=10)
        except Exception as err:  # noqa: BLE001 (surfaces in problems)
            fit_errors.append(f"{name}: {err!r}")
        finally:
            # close in the consuming thread: the generator is suspended
            # inside trace_scope(), whose token resets only in its context
            batches.close()

    for name in workers:
        t = threading.Thread(target=run_worker, args=(name,), name=f"train-step-{name}",
                             daemon=True)
        threads.append(t)
        t.start()

    straggler_key = "train-straggler[worker-1]"
    fired_during_baseline: List[str] = []
    fired: List[str] = []
    resolved = False
    stats: Dict = {}
    arc: Dict = {}

    def drive(seconds: float, until: Optional[Callable[[], bool]] = None) -> bool:
        deadline = clock.monotonic() + seconds
        while clock.monotonic() < deadline:
            view.observe()
            if until is not None and until():
                return True
            time.sleep(0.25)
        return until() if until is not None else True

    try:
        # phase 1, baseline: both workers healthy, nothing may fire
        drive(4.0)
        fired_during_baseline = list(manager.firing())
        arc = {"baseline": view.last_report}
        # phase 2, chaos: worker-1's input gains delay_s a batch; its
        # step rate falls below 0.7x the fleet median
        injected_delay["worker-1"] = delay_s
        drive(30.0, until=lambda: straggler_key in manager.firing())
        fired = list(manager.firing())
        arc["fired"] = view.last_report
        # phase 3, recovery: the fault is off; the straggler must resolve
        injected_delay["worker-1"] = 0.0
        resolved = drive(30.0, until=lambda: not manager.firing())
        arc["resolved"] = view.last_report
        # the rest of the budget at full speed
        pace["s"] = 0.0
        for t in threads:
            t.join(timeout=120.0)
        stats = profiler.stats()  # while running: elapsed_seconds is set
        # a final fleet pass and page scrape while the servers are up
        report = view.observe()
        pages = {n: {"healthz": w["client"].healthz(), "slozz": w["client"].slozz()}
                 for n, w in workers.items()}
    finally:
        pace["s"] = 0.0
        profiler.stop()
        for w in workers.values():
            w["telemetry"].stop()

    problems: List[str] = list(fit_errors)
    if any(t.is_alive() for t in threads):
        problems.append("a worker did not finish its step budget")
    if fired_during_baseline:
        problems.append(f"alerts fired on baseline traffic: {fired_during_baseline}")
    if straggler_key not in fired:
        problems.append(f"train-straggler never fired under chaos (firing={fired})")
    if not resolved:
        problems.append(f"straggler did not resolve after the fault cleared "
                        f"(still firing: {manager.firing()})")
    if fault_log.counts().get(FAULT_LATENCY, 0) < 1:
        problems.append("no FAULT_LATENCY records in the fault log")

    # the alert flight records: firing and resolved transitions, trace-
    # correlated with the slow worker's steps
    alert_records = [r.to_dict() for r in flight.snapshot(kind="alert")]
    states: Dict[str, List] = {}
    for rec in alert_records:
        states.setdefault(rec["fields"].get("state"), []).append(rec)
    if not states.get("firing"):
        problems.append("no firing alert flight records")
    if not states.get("resolved"):
        problems.append("no resolved alert flight records")
    sampled = {t for rec in alert_records
               for t in str(rec["fields"].get("traces", "")).split(",") if t}
    if not sampled & set(slow_traces):
        problems.append(f"alert trace samples {sorted(sampled)[:4]} do not intersect the "
                        f"slowed steps {slow_traces[:4]}")

    coverage: Dict[str, float] = {}
    overhead: Dict[str, float] = {}
    for name, w in workers.items():
        timer = w["trainer"].phase_timer
        ledger = w["trainer"].goodput
        coverage[name] = timer.coverage()
        overhead[name] = timer.overhead_fraction()
        if timer.coverage() < 0.95:
            problems.append(f"{name}: phase attribution covers only {timer.coverage():.3f} "
                            "of step wall (< 0.95)")
        if timer.overhead_fraction() >= 0.02:
            problems.append(f"{name}: attribution overhead {timer.overhead_fraction():.4f} "
                            ">= 2% of step time")
        executed = timer.steps
        if not ledger.reconciles(executed):
            problems.append(f"{name}: goodput ledger accounts {ledger.accounted_steps()} "
                            f"steps but the loop executed {executed}")
        state = w.get("state")
        if state is not None and int(state.step) != executed:
            problems.append(f"{name}: step counter {int(state.step)} != {executed} timed steps")

    duty = (stats["sample_seconds"] / stats["elapsed_seconds"]
            if stats.get("elapsed_seconds") else 0.0)
    if not stats.get("elapsed_seconds"):
        problems.append("the sampling profiler was not running at the end of the run")
    if device.type == "cuda" and duty >= 0.02:
        problems.append(f"sampling-profiler duty cycle {duty:.4f} >= 2%")

    # the status fold lands in status.extra and survives a JSON round trip
    job = types.SimpleNamespace(
        metadata=types.SimpleNamespace(name=namespace, namespace=namespace),
        status=types.SimpleNamespace(extra={}),
    )
    fold_train_observability(job, report)
    extra = json.loads(json.dumps(job.status.extra))
    if extra.get("trainObservability", {}).get("lastStep") != report["last_step"]:
        problems.append("trainObservability did not round-trip through JSON")

    # the pages: healthz reached training, slozz renders goodput and phases
    for name, page in pages.items():
        phase = page["healthz"].get("phase")
        if phase not in ("training", "checkpointing"):
            problems.append(f"{name}: healthz phase {phase!r} never reached training")
        block = page["slozz"].get("train", {})
        if "goodput" not in block or "phases" not in block:
            problems.append(f"{name}: /debug/slozz missing goodput/phases (got {sorted(block)})")
    summary = {
        "seed": seed,
        "steps": steps,
        "device": str(device),
        "fired": fired,
        "resolved": resolved,
        "straggler_key": straggler_key,
        "latency_faults": fault_log.counts().get(FAULT_LATENCY, 0),
        "slow_traces": slow_traces[:8],
        "alert_records": len(alert_records),
        "phase_coverage": {n: round(c, 4) for n, c in coverage.items()},
        "attribution_overhead": {n: round(o, 6) for n, o in overhead.items()},
        "profiler_duty_cycle": round(duty, 6),
        "profiler_samples": stats.get("samples_total", 0),
        "profiler_stats": {k: stats.get(k) for k in (
            "ticks", "sample_seconds", "sample_wall_seconds", "max_tick_seconds",
            "elapsed_seconds")},
        "goodput": {n: w["trainer"].goodput.snapshot() for n, w in workers.items()},
        "fleet": report,
        # each worker's steps/s at the end of the baseline, when the
        # straggler fired and when it resolved
        "rates": {stage: {n: w["steps_per_sec"] for n, w in (r or {}).get("workers", {}).items()}
                  for stage, r in arc.items()},
        "status_extra": extra,
        "problems": problems,
        "seconds": round(clock.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(f"train observe smoke failed: {json.dumps(summary)}")
    return summary


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.train.observe",
        description="the training observatory smoke",
    )
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    if not args.smoke:
        parser.print_help()
        return 2
    summary = run_train_observe_smoke(seed=args.seed, steps=args.steps, device=args.device)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
