"""Labeled metric registry: the port's copy of the part of
tf_operator_tpu/telemetry/registry.py that the trainer feeds (Counter,
Gauge and Histogram families, optional labels, fixed histogram buckets).
The text exposition (render) comes with the worker's telemetry server
in a later slice (ROADMAP queue 1).

Every family carries its own lock. Registration is get-or-create: asking
for an existing (name, kind, labelnames, buckets) returns the same
family, so several Trainers can feed the default registry; a conflicting
re-registration raises.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional, Sequence, Tuple

from ..utils import locks

# optimizer steps: from a tiny model on the CPU to a large one on a card
STEP_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0,
)


class _Child:
    """One (family, label set) time series."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: "_Family", key: Tuple[str, ...]):
        self._family = family
        self._key = key


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        fam = self._family
        with fam._lock:
            fam._values[self._key] += amount

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._family._values[self._key]


class GaugeChild(_Child):
    def set(self, value: float) -> None:
        fam = self._family
        with fam._lock:
            fam._values[self._key] = float(value)

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._family._values[self._key]


class HistogramChild(_Child):
    def observe(self, value: float) -> None:
        fam = self._family
        v = float(value)
        with fam._lock:
            counts, stats = fam._values[self._key]
            counts[bisect.bisect_left(fam.buckets, v)] += 1
            stats[0] += v
            stats[1] += 1

    @property
    def count(self) -> int:
        with self._family._lock:
            return int(self._family._values[self._key][1][1])


class _Family:
    """One metric family: name, kind, help, label schema, children.
    An unlabeled family proxies its single child, so
    `registry.counter("x", "...").inc()` works."""

    kind = ""
    CHILD = _Child

    def __init__(
        self, name: str, help_text: str, labelnames: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]] = None,
    ):
        self.name = name
        self.help = help_text
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = locks.make_lock("_Family._lock")
        self._values: Dict[Tuple[str, ...], object] = {}
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self.CHILD(self, key)
                self._values[key] = self._zero()
            return child

    def _zero(self):
        return 0.0

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; call .labels(...) first")
        return self.labels()


class CounterFamily(_Family):
    kind = "counter"
    CHILD = CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    @property
    def value(self) -> float:
        return self._only().value


class GaugeFamily(_Family):
    kind = "gauge"
    CHILD = GaugeChild

    def set(self, value: float) -> None:
        self._only().set(value)

    @property
    def value(self) -> float:
        return self._only().value


class HistogramFamily(_Family):
    kind = "histogram"
    CHILD = HistogramChild

    def _zero(self):
        # per-bucket (non-cumulative) counts incl. the +Inf overflow,
        # plus [sum, count]
        return [0] * (len(self.buckets) + 1), [0.0, 0]

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def count(self) -> int:
        return self._only().count


class MetricRegistry:
    """Families keyed by name."""

    def __init__(self) -> None:
        self._lock = locks.make_lock("MetricRegistry._lock")
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help_text, labelnames, buckets=None):
        labelnames = tuple(labelnames)
        if buckets is not None:
            buckets = tuple(sorted(float(b) for b in buckets if float(b) != float("inf")))
            if not buckets or len(set(buckets)) != len(buckets):
                raise ValueError(f"{name}: histogram needs distinct bucket bounds")
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if (type(existing) is not cls or existing.labelnames != labelnames
                        or existing.buckets != buckets):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames} and the "
                        "new registration conflicts"
                    )
                return existing
            family = self._families[name] = cls(name, help_text, labelnames, buckets)
            return family

    def counter(
        self, name: str, help_text: str, labelnames: Sequence[str] = (),
    ) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help_text, labelnames)

    def gauge(
        self, name: str, help_text: str, labelnames: Sequence[str] = (),
    ) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help_text, labelnames)

    def histogram(
        self, name: str, help_text: str, buckets: Sequence[float] = STEP_BUCKETS,
        labelnames: Sequence[str] = (),
    ) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help_text, labelnames, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)
