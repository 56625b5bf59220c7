"""Labeled metric registry with Prometheus text exposition: the port's
copy of tf_operator_tpu/telemetry/registry.py (Counter, Gauge and
Histogram families, optional labels, fixed histogram buckets rendered as
cumulative `_bucket{le=...}` rows plus `_sum`/`_count`, text format
0.0.4). The trainer feeds it; the decode server (serve/server.py)
renders it at /metrics.

Every family carries its own lock. Registration is get-or-create: asking
for an existing (name, kind, labelnames, buckets) returns the same
family, so several Trainers can feed the default registry; a conflicting
re-registration raises.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import locks

# Prometheus' classic latency spread: TTFT and whole-request times
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
# per-token and queue-hop durations: sub-millisecond resolution
FAST_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
)
# first-token and prefill-chunk latencies: sub-millisecond below 1 ms,
# then ~1.5x steps
TTFT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03,
    0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 5.0,
)
# client-go workqueue convention (queue and work durations):
# microseconds up to ~10 s
WORKQUEUE_BUCKETS: Tuple[float, ...] = (
    1e-06, 1e-05, 0.0001, 0.001, 0.01, 0.1, 1.0, 10.0,
)
# batch and slot occupancy
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
# optimizer steps: from a tiny model on the CPU to a large one on a card
STEP_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0,
)

_INF = float("inf")


def format_value(value: float) -> str:
    """Exposition-format number: integers without a trailing .0, floats
    via repr (round-trip exact)."""
    f = float(value)
    if f == _INF:
        return "+Inf"
    if f == -_INF:
        return "-Inf"
    if f != f:  # NaN
        return "NaN"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(value: str) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in zip(labelnames, labelvalues))


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

    def inc(self, amount: float = 1.0) -> None:
        fam = self._family
        with fam._lock:
            fam._values[self._key] += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

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
    `registry.counter("x", "...").inc()` works, and renders from birth."""

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
        if not labelnames:
            self.labels()

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

    def _render_samples(self, full: str, lines: List[str]) -> None:
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            labels = _label_str(self.labelnames, key)
            suffix = "{%s}" % labels if labels else ""
            lines.append(f"{full}{suffix} {format_value(value)}")


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

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

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

    def _render_samples(self, full: str, lines: List[str]) -> None:
        with self._lock:
            items = sorted((key, [list(v[0]), list(v[1])]) for key, v in self._values.items())
        for key, (counts, stats) in items:
            labels = _label_str(self.labelnames, key)
            acc = 0
            for le, c in zip(list(self.buckets) + [_INF], counts):
                acc += c
                le_label = f'le="{format_value(le)}"'
                all_labels = f"{labels},{le_label}" if labels else le_label
                lines.append(f"{full}_bucket{{{all_labels}}} {acc}")
            suffix = "{%s}" % labels if labels else ""
            lines.append(f"{full}_sum{suffix} {format_value(stats[0])}")
            lines.append(f"{full}_count{suffix} {int(stats[1])}")


class MetricRegistry:
    """Families keyed by (unprefixed) name; render() emits the whole
    exposition page with the registry prefix applied."""

    def __init__(self, prefix: str = "") -> None:
        self.prefix = prefix
        self._lock = locks.make_lock("MetricRegistry._lock")
        self._families: Dict[str, _Family] = {}

    def full_name(self, name: str) -> str:
        return f"{self.prefix}_{name}" if self.prefix else name

    def _get_or_create(self, cls, name, help_text, labelnames, buckets=None):
        labelnames = tuple(labelnames)
        if buckets is not None:
            buckets = tuple(sorted(float(b) for b in buckets if float(b) != _INF))
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

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        lines: List[str] = []
        for family in self.families():
            full = self.full_name(family.name)
            lines.append(f"# HELP {full} {family.help}")
            lines.append(f"# TYPE {full} {family.kind}")
            family._render_samples(full, lines)
        return "\n".join(lines) + "\n"


def histogram_quantile(
    q: float, buckets: Sequence[Tuple[float, float]],
) -> Optional[float]:
    """PromQL-style estimated quantile from cumulative (le, count) pairs
    (ascending, ending +Inf): linear inside the target bucket, the +Inf
    bucket clamped to the last finite bound. None when empty."""
    if not buckets:
        return None
    buckets = sorted((float(le), float(c)) for le, c in buckets)
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if math.isinf(le):
                return prev_le
            if count == prev_count:
                return le
            return prev_le + (le - prev_le) * ((rank - prev_count) / (count - prev_count))
        prev_le, prev_count = le, count
    return buckets[-1][0]
