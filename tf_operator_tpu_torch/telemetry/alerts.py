"""Declarative alert rules evaluated against metric history: the port's
copy of tf_operator_tpu/telemetry/alerts.py.

- `BurnRateRule`: the multi-window error-budget pattern for the serve
  SLOs. The burn rate is the window's bad fraction over the budget
  (1 - objective); each window fires on its own, a fast one for spikes
  and a slow one for leaks. The threshold sits on a histogram bucket
  edge, so bad and good are read straight off the cumulative vector.
- `ThresholdRule`: level checks with hysteresis (fire above
  `fire_above`, held for `for_s`; resolve only at or below
  `resolve_below`), on the latest value, a counter's rate or a ratio.

`AlertManager` runs the firing -> resolved state machine on
`Clock.monotonic()`. Every transition writes a `kind="alert"` flight
record with the rule, value, threshold and a sample of recently active
trace ids, sets an `alerts_firing{rule}` gauge, and shows at
/debug/alertz (`render_alertz`). A partial evaluation (a worker scrape
failed) holds firing states: missing data never clears an alert.

Rule packs: `serve_replica_rules` (the decode server), `fleet_rules`
(the serve fleet's observatory, serve/observatory.py) and `train_rules`
(the training fleet view). The operator's pack is not part of this copy.
Stdlib only.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import locks
from .flight import FlightRecorder, default_flight
from .history import MetricHistory
from .registry import MetricRegistry

__all__ = [
    "BurnRateRule",
    "ThresholdRule",
    "AlertManager",
    "render_alertz",
    "fleet_rules",
    "serve_replica_rules",
    "train_rules",
]


class _Instance:
    """One (rule, window) firing state — the unit the state machine
    tracks and the gauge labels."""

    __slots__ = (
        "rule", "key", "evaluate", "fire_above", "resolve_below",
        "for_s", "state", "since", "pending_since", "value",
        "transitions", "last_transition",
    )

    def __init__(
        self, rule, key, evaluate, fire_above, resolve_below, for_s
    ):
        self.rule = rule
        self.key = key
        self.evaluate = evaluate  # (history, now) -> Optional[float]
        self.fire_above = fire_above
        self.resolve_below = resolve_below
        self.for_s = for_s
        self.state = "ok"  # ok | pending | firing
        self.since: Optional[float] = None
        self.pending_since: Optional[float] = None
        self.value: Optional[float] = None
        self.transitions = 0
        self.last_transition: Optional[float] = None


class BurnRateRule:
    """Multi-window burn-rate rule over a histogram series.

    threshold_s MUST align with a bucket edge of the series (the
    nearest edge >= threshold_s is what actually gets measured);
    objective is the good fraction promised (0.95 -> 5% budget);
    windows is ((window_s, fire_burn), ...) — burn above fire_burn
    fires that window, burn back under fire_burn * resolve_ratio
    resolves it (hysteresis)."""

    def __init__(
        self,
        name: str,
        series: str,
        threshold_s: float,
        objective: float = 0.95,
        windows: Sequence[Tuple[float, float]] = (
            (60.0, 14.4),   # fast: a spike burning 14.4x budget
            (300.0, 6.0),   # slow: a leak burning 6x budget
        ),
        resolve_ratio: float = 0.8,
        description: str = "",
    ) -> None:
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1): {objective}")
        self.name = name
        self.series = series
        self.threshold_s = float(threshold_s)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows = tuple((float(w), float(b)) for w, b in windows)
        self.resolve_ratio = float(resolve_ratio)
        self.description = description

    def instances(self) -> List[_Instance]:
        out = []
        for window_s, fire_burn in self.windows:
            def evaluate(
                history: MetricHistory, now: float,
                _w=window_s,
            ) -> Optional[float]:
                bad = history.bad_fraction(
                    self.series, self.threshold_s, _w, now=now
                )
                return None if bad is None else bad / self.budget

            out.append(_Instance(
                rule=self,
                key=f"{self.name}[{window_s:g}s]",
                evaluate=evaluate,
                fire_above=fire_burn,
                resolve_below=fire_burn * self.resolve_ratio,
                for_s=0.0,  # the window IS the damper
            ))
        return out

    def describe(self) -> Dict:
        return {
            "rule": self.name,
            "type": "burn_rate",
            "series": self.series,
            "threshold_s": self.threshold_s,
            "objective": self.objective,
            "windows": [list(w) for w in self.windows],
            "description": self.description,
        }


class ThresholdRule:
    """Level rule with hysteresis over a scalar reading of a series."""

    def __init__(
        self,
        name: str,
        series: str,
        fire_above: float,
        resolve_below: Optional[float] = None,
        for_s: float = 0.0,
        mode: str = "latest",
        window_s: float = 300.0,
        denominator: Optional[str] = None,
        description: str = "",
    ) -> None:
        if mode not in ("latest", "rate", "ratio"):
            raise ValueError(f"mode must be latest|rate|ratio: {mode}")
        if mode == "ratio" and not denominator:
            raise ValueError(f"{name}: mode=ratio needs denominator=")
        self.name = name
        self.series = series
        self.fire_above = float(fire_above)
        self.resolve_below = (
            float(resolve_below) if resolve_below is not None
            else float(fire_above)
        )
        if self.resolve_below > self.fire_above:
            raise ValueError(
                f"{name}: resolve_below {self.resolve_below} above "
                f"fire_above {self.fire_above} would latch forever"
            )
        self.for_s = float(for_s)
        self.mode = mode
        self.window_s = float(window_s)
        self.denominator = denominator
        self.description = description

    def _value(
        self, history: MetricHistory, now: float
    ) -> Optional[float]:
        if self.mode == "rate":
            return history.rate(self.series, self.window_s, now=now)
        latest = history.latest(self.series)
        if latest is None or isinstance(latest, tuple):
            return None
        if self.mode == "ratio":
            den = history.latest(self.denominator)
            if den is None or isinstance(den, tuple) or float(den) <= 0:
                return None
            return float(latest) / float(den)
        return float(latest)

    def instances(self) -> List[_Instance]:
        return [_Instance(
            rule=self,
            key=self.name,
            evaluate=self._value,
            fire_above=self.fire_above,
            resolve_below=self.resolve_below,
            for_s=self.for_s,
        )]

    def describe(self) -> Dict:
        return {
            "rule": self.name,
            "type": "threshold",
            "series": self.series,
            "mode": self.mode,
            "fire_above": self.fire_above,
            "resolve_below": self.resolve_below,
            "for_s": self.for_s,
            "description": self.description,
        }


class AlertManager:
    """Evaluates rules against history; owns the firing state.

    State machine per instance, all on clock.monotonic():

        ok --value > fire_above--> pending (for_s > 0) or firing
        pending --held for for_s--> firing
        pending --value <= resolve_below--> ok       (no event)
        firing --value <= resolve_below--> resolved -> ok

    No data (evaluate -> None) HOLDS the current state — an alert
    must not resolve because the scrape died. partial=True holds
    firing states the same way even when data is present (the fleet
    sample was incomplete, so a healthy-looking window is suspect)."""

    def __init__(
        self,
        history: MetricHistory,
        rules: Sequence,
        registry: Optional[MetricRegistry] = None,
        clock=None,
        flight: Optional[FlightRecorder] = None,
        trace_sampler: Optional[Callable[[], List[str]]] = None,
    ) -> None:
        self.history = history
        self.rules = list(rules)
        self.clock = clock if clock is not None else history.clock
        self.flight = flight if flight is not None else default_flight()
        self._trace_sampler = trace_sampler
        self._lock = locks.make_lock("AlertManager._lock")
        self._instances: List[_Instance] = []
        for rule in self.rules:
            self._instances.extend(rule.instances())
        self._firing_gauge = None
        if registry is not None:
            self._firing_gauge = registry.gauge(
                "alerts_firing",
                "1 while the labeled alert rule instance is firing",
                labelnames=("rule",),
            )
            for inst in self._instances:
                self._firing_gauge.labels(rule=inst.key).set(0)
        self.evaluations = 0
        self.partial = False
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- background cadence --------------------------------------------------

    def start(
        self, interval_s: float = 5.0, tick_history: bool = True
    ) -> None:
        """Sample + evaluate on a daemon thread every interval_s (the
        server cadence; tests drive tick()/evaluate() by hand)."""
        if self._ticker is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                if tick_history:
                    self.history.tick()
                self.evaluate()

        self._ticker = threading.Thread(
            target=run, name="alert-manager", daemon=True
        )
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        ticker, self._ticker = self._ticker, None
        if ticker is not None:
            ticker.join(timeout=5.0)

    # -- trace correlation ---------------------------------------------------

    def _recent_traces(self, limit: int = 5) -> List[str]:
        """Trace ids seen on recent flight records: the requests in
        flight around the transition. A custom sampler wins when
        provided."""
        if self._trace_sampler is not None:
            try:
                return list(self._trace_sampler())[:limit]
            except Exception:  # noqa: BLE001 — alerting must not die
                # on a diagnostics helper
                return []
        if self.flight is None:
            return []
        seen: List[str] = []
        for record in reversed(self.flight.snapshot(limit=400)):
            if record.kind == "alert":
                continue
            trace = record.fields.get("trace")
            if trace and trace not in seen:
                seen.append(str(trace))
            if len(seen) >= limit:
                break
        return seen

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, partial: Optional[bool] = None) -> List[Dict]:
        """One evaluation pass; -> the transitions that happened."""
        if partial is None:
            partial = self.partial
        now = self.clock.monotonic()
        transitions: List[Dict] = []
        with self._lock:
            self.evaluations += 1
            for inst in self._instances:
                try:
                    value = inst.evaluate(self.history, now)
                except Exception:  # noqa: BLE001 — a broken rule must
                    # not stop the others from evaluating
                    value = None
                inst.value = value
                if value is None:
                    continue  # hold state: no data is not "healthy"
                if inst.state == "firing":
                    if value <= inst.resolve_below and not partial:
                        self._transition(inst, "resolved", value, now)
                        inst.state = "ok"
                        inst.since = None
                        transitions.append(
                            self._event(inst, "resolved", value, now)
                        )
                elif value > inst.fire_above:
                    if inst.for_s <= 0:
                        self._fire(inst, value, now, transitions)
                    elif inst.state == "pending":
                        if now - inst.pending_since >= inst.for_s:
                            self._fire(inst, value, now, transitions)
                    else:
                        inst.state = "pending"
                        inst.pending_since = now
                elif inst.state == "pending" and value <= inst.resolve_below:
                    inst.state = "ok"
                    inst.pending_since = None
        return transitions

    def _fire(self, inst: _Instance, value, now, transitions) -> None:
        self._transition(inst, "firing", value, now)
        inst.state = "firing"
        inst.since = now
        inst.pending_since = None
        transitions.append(self._event(inst, "firing", value, now))

    def _event(self, inst: _Instance, state, value, now) -> Dict:
        return {
            "rule": inst.rule.name,
            "instance": inst.key,
            "state": state,
            "value": round(float(value), 6),
            "at_mono": round(now, 6),
        }

    def _transition(self, inst: _Instance, state, value, now) -> None:
        inst.transitions += 1
        inst.last_transition = now
        if self._firing_gauge is not None:
            self._firing_gauge.labels(rule=inst.key).set(
                1 if state == "firing" else 0
            )
        if self.flight is not None:
            threshold = (
                inst.fire_above if state == "firing"
                else inst.resolve_below
            )
            self.flight.record(
                "alert",
                rule=inst.rule.name,
                instance=inst.key,
                series=inst.rule.series,
                state=state,
                value=round(float(value), 6),
                threshold=threshold,
                traces=",".join(self._recent_traces()),
            )

    # -- introspection -------------------------------------------------------

    def firing(self) -> List[str]:
        with self._lock:
            return [
                inst.key for inst in self._instances
                if inst.state == "firing"
            ]

    def status(self) -> Dict:
        now = self.clock.monotonic()
        with self._lock:
            instances = [
                {
                    "rule": inst.rule.name,
                    "instance": inst.key,
                    "series": inst.rule.series,
                    "state": inst.state,
                    "value": (
                        round(inst.value, 6)
                        if isinstance(inst.value, float) else inst.value
                    ),
                    "fire_above": inst.fire_above,
                    "resolve_below": inst.resolve_below,
                    "for_s": inst.for_s,
                    "since_s": (
                        round(now - inst.since, 3)
                        if inst.since is not None else None
                    ),
                    "transitions": inst.transitions,
                }
                for inst in self._instances
            ]
        return {
            "evaluations": self.evaluations,
            "partial": self.partial,
            "firing": [
                i["instance"] for i in instances if i["state"] == "firing"
            ],
            "rules": [rule.describe() for rule in self.rules],
            "instances": instances,
        }


# -- default rule sets -------------------------------------------------------

def serve_replica_rules(
    prefix: str = "tf_operator_tpu_serve",
    ttft_slo_s: float = 0.25,
    ttft_objective: float = 0.95,
    windows: Sequence[Tuple[float, float]] = (
        (60.0, 14.4), (300.0, 6.0),
    ),
) -> List:
    """The per-replica serve rule set: TTFT burn rate plus engine
    pressure levels. 0.25s sits on a TTFT_BUCKETS edge."""
    return [
        BurnRateRule(
            "ttft-slo", f"{prefix}_ttft_seconds",
            threshold_s=ttft_slo_s, objective=ttft_objective,
            windows=windows,
            description=(
                f"{ttft_objective:.0%} of first tokens under "
                f"{ttft_slo_s * 1000:g}ms"
            ),
        ),
        ThresholdRule(
            "queue-depth", "engine_queue_depth",
            fire_above=16, resolve_below=8, for_s=10.0,
            description="admission queue backing up",
        ),
        ThresholdRule(
            "kv-occupancy", "engine_kv_blocks_in_use",
            denominator="engine_kv_blocks_total", mode="ratio",
            fire_above=0.9, resolve_below=0.75, for_s=10.0,
            description="paged KV pool nearly exhausted",
        ),
        ThresholdRule(
            "pool-audit-failures", "engine_pool_audit_failures_total",
            mode="rate", window_s=300.0, fire_above=0.0,
            description="block pool accounting violations (leak or "
            "double free)",
        ),
    ]


def fleet_rules(
    ttft_slo_s: float = 0.25,
    ttft_objective: float = 0.95,
    windows: Sequence[Tuple[float, float]] = (
        (60.0, 14.4), (300.0, 6.0),
    ),
) -> List:
    """The observatory's fleet-level rule set, over the series the
    observatory ingests from replica scrapes (fleet-summed cumulative
    buckets — the never-average rule's composable form)."""
    return [
        BurnRateRule(
            "fleet-ttft-slo", "fleet_ttft_seconds",
            threshold_s=ttft_slo_s, objective=ttft_objective,
            windows=windows,
            description=(
                f"fleet-wide: {ttft_objective:.0%} of first tokens "
                f"under {ttft_slo_s * 1000:g}ms"
            ),
        ),
        ThresholdRule(
            "fleet-kv-occupancy", "fleet_kv_blocks_in_use",
            denominator="fleet_kv_blocks_total", mode="ratio",
            fire_above=0.9, resolve_below=0.75, for_s=10.0,
            description="fleet paged KV pools nearly exhausted",
        ),
        ThresholdRule(
            "fleet-scrape-errors", "fleet_scrape_errors",
            fire_above=0.5, resolve_below=0.5, for_s=30.0,
            description="replica scrapes failing (fleet sample "
            "partial)",
        ),
        ThresholdRule(
            "fleet-kv-cached-idle-pressure",
            "fleet_kv_cached_idle_blocks",
            denominator="fleet_kv_blocks_total", mode="ratio",
            fire_above=0.5, resolve_below=0.35, for_s=10.0,
            description="over half the fleet's KV blocks sit as idle "
            "cached prefixes (duplication pressure: reclaim churn "
            "ahead; fleet peer fetch would convert these to hits)",
        ),
    ]


# -- /debug/alertz -----------------------------------------------------------

def train_rules(
    workers: Sequence[str],
    straggler_ratio: float = 0.7,
    stall_k: float = 8.0,
    for_s: float = 0.0,
) -> List:
    """The training-plane rule pack, over the per-worker skew series
    the TrainFleetView (train/observe.py) ingests from worker scrapes:

    - ``train-straggler[w]`` — the worker's step rate fell below
      `straggler_ratio` x the fleet median (the slowdown gauge is
      median_rate / worker_rate, so the fire line is its reciprocal);
      resolves with hysteresis well below the fire line so a worker
      hovering at the threshold doesn't flap.
    - ``train-stall[w]`` — no step progress for `stall_k` x the fleet
      median step time (the synchronous-collective death knell: one
      stalled worker holds every peer's all-reduce hostage).

    One rule pair per worker name: the fleet view writes one labeled
    gauge sample per worker, and ThresholdRule instances are keyed by
    rule name, so the per-worker series name is baked in here."""
    rules: List = []
    for worker in workers:
        rules.append(ThresholdRule(
            f"train-straggler[{worker}]",
            f'tf_operator_tpu_train_fleet_worker_slowdown'
            f'{{worker="{worker}"}}',
            fire_above=1.0 / straggler_ratio,
            resolve_below=1.15,
            for_s=for_s,
            description=(
                f"{worker} step rate below {straggler_ratio:g}x the "
                "fleet median"
            ),
        ))
        rules.append(ThresholdRule(
            f"train-stall[{worker}]",
            f'tf_operator_tpu_train_fleet_worker_stall_ratio'
            f'{{worker="{worker}"}}',
            fire_above=stall_k,
            resolve_below=max(2.0, stall_k / 4.0),
            for_s=for_s,
            description=(
                f"{worker} made no step progress for {stall_k:g}x the "
                "median step time"
            ),
        ))
    return rules


def render_alertz(manager: AlertManager, query: str = "") -> bytes:
    """The shared /debug/alertz page: one JSON document of rules,
    instance states, and current values. `?firing=1` keeps only the
    instances currently firing."""
    from urllib.parse import parse_qs

    params = parse_qs(query or "", keep_blank_values=False)
    doc = manager.status()
    if params.get("firing", [""])[0] == "1":
        doc["instances"] = [
            i for i in doc["instances"] if i["state"] == "firing"
        ]
    return (json.dumps(doc, indent=1) + "\n").encode()
