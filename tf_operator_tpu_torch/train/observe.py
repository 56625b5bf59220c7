"""Training-plane observability: the port's copy of the step-phase timer,
the goodput ledger and the lifecycle phase from tf_operator_tpu/train/observe.py.

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

Timing goes through the Clock.monotonic seam (controller/clock.py), so
FakeClock drives them in tests. `TrainTelemetry`, `TrainFleetView` and
the worker telemetry server are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..controller.clock import Clock
from ..telemetry import STEP_BUCKETS, MetricRegistry, default_registry
from ..telemetry.flight import flight_record
from ..utils import locks

logger = logging.getLogger("tf_operator_tpu_torch.train.observe")

__all__ = ["PHASES", "WASTE_REASONS", "StepPhaseTimer", "GoodputLedger", "HealthPhase"]

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
