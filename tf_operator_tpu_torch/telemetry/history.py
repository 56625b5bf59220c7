"""Bounded time-series history over the metric registry: the port's copy
of tf_operator_tpu/telemetry/history.py.

A preallocated, bounded ring per tracked series (the flight recorder's
overwrite-oldest discipline), sampled on a cadence and queried by window:

- counters are stored as the raw cumulative value; `rate()` and `delta()`
  difference the window's edge samples, reading a negative difference as
  a restart from zero;
- gauges are stored as point reads;
- histograms are stored as the full cumulative bucket vector (plus sum
  and count), so `quantile_over_window()` differences the vectors at the
  window edges and interpolates with `histogram_quantile`.

Sources: registry families (`track_registry`), flat provider dicts in the
engine's `{(name, kind): value}` shape (`track_flat`), single callables
(`track_provider`) and pushed samples (`ingest_value`,
`ingest_histogram`: how the fleet view feeds its per-worker series).
`tick()` samples every source once (tests drive it with a FakeClock);
`start(interval)` runs it on a daemon thread. `render_historyz()` is the
/debug/historyz page. Stdlib only.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import locks
from .registry import (
    HistogramFamily,
    MetricRegistry,
    _label_str,
    histogram_quantile,
)

__all__ = [
    "HistSample",
    "MetricHistory",
    "render_historyz",
]

_INF = float("inf")

# (les, cumulative counts, sum, count) — one histogram observation
HistSample = Tuple[Tuple[float, ...], Tuple[float, ...], float, float]


class _Series:
    """One tracked time series: a preallocated ring of (t, wall,
    value) samples, overwrite-oldest — the flight-ring discipline."""

    __slots__ = ("name", "family", "kind", "capacity", "_buf", "_seq")

    def __init__(self, name: str, family: str, kind: str, capacity: int):
        self.name = name
        self.family = family
        self.kind = kind
        self.capacity = capacity
        # preallocated: append() stores into an existing slot
        self._buf: List[Optional[tuple]] = [None] * capacity
        self._seq = 0

    def append(self, t: float, wall: float, value) -> None:
        self._buf[self._seq % self.capacity] = (t, wall, value)
        self._seq += 1

    def snapshot(self) -> List[tuple]:
        """Samples currently in the ring, oldest first."""
        seq = self._seq
        start = max(0, seq - self.capacity)
        return [
            s for i in range(start, seq)
            if (s := self._buf[i % self.capacity]) is not None
        ]

    def __len__(self) -> int:
        return min(self._seq, self.capacity)


class MetricHistory:
    """Rings of sampled series plus the windowed queries over them.

    capacity bounds samples *per series*; with the default 512 slots
    and a 5s cadence one ring remembers ~42 minutes — enough for the
    slow burn-rate windows with room to spare, at ~12KB a series."""

    def __init__(self, capacity: int = 512, clock=None) -> None:
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        if clock is None:
            from ..controller.clock import Clock

            clock = Clock()
        self.clock = clock
        self._lock = locks.make_lock("MetricHistory._lock")
        self._series: Dict[str, _Series] = {}
        self._registries: List[Tuple[MetricRegistry, Optional[set]]] = []
        self._flat_providers: List[Callable[[], Dict]] = []
        self._providers: List[Tuple[str, str, Callable[[], float]]] = []
        self.sample_errors = 0
        self.ticks = 0
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sources -------------------------------------------------------------

    def track_registry(
        self,
        registry: MetricRegistry,
        names: Optional[Sequence[str]] = None,
    ) -> None:
        """Sample this registry's families every tick. `names` limits
        tracking to the listed *unprefixed* family names (None = every
        family, including ones registered after this call)."""
        with self._lock:
            self._registries.append(
                (registry, set(names) if names is not None else None)
            )

    def track_flat(self, provider: Callable[[], Dict]) -> None:
        """Sample a `{(name, kind): value}` flat dict every tick — the
        engine.metrics() shape, which never goes through a registry."""
        with self._lock:
            self._flat_providers.append(provider)

    def track_provider(
        self, name: str, kind: str, fn: Callable[[], float]
    ) -> None:
        """Sample one scalar callable every tick as `name` (kind is
        'counter' or 'gauge')."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"provider kind must be counter|gauge: {kind}")
        with self._lock:
            self._providers.append((name, kind, fn))

    # -- push ingestion (the fleet view's per-worker series) -----------------

    def _get_series(self, name: str, family: str, kind: str) -> _Series:
        series = self._series.get(name)
        if series is None:
            series = _Series(name, family, kind, self.capacity)
            self._series[name] = series
        return series

    def ingest_value(self, name: str, kind: str, value: float) -> None:
        """Push one counter/gauge sample stamped with the history's
        clock (aggregates a caller computes itself, such as the fleet
        view's per-worker step counters)."""
        t = self.clock.monotonic()
        wall = self.clock.now().timestamp()
        with self._lock:
            self._get_series(name, name, kind).append(
                t, wall, float(value)
            )

    def ingest_histogram(
        self,
        name: str,
        cumulative: Sequence[Tuple[float, float]],
        total_sum: float = 0.0,
    ) -> None:
        """Push one cumulative (le, count) bucket vector — ascending,
        ending +Inf — e.g. the fleet-summed TTFT buckets."""
        pairs = sorted((float(le), float(c)) for le, c in cumulative)
        if not pairs:
            return
        les = tuple(le for le, _ in pairs)
        counts = tuple(c for _, c in pairs)
        sample: HistSample = (les, counts, float(total_sum), counts[-1])
        t = self.clock.monotonic()
        wall = self.clock.now().timestamp()
        with self._lock:
            self._get_series(name, name, "histogram").append(
                t, wall, sample
            )

    # -- sampling ------------------------------------------------------------

    def tick(self) -> int:
        """Sample every tracked source once; -> series touched. The
        whole pass holds the history lock — ticks are seconds apart
        and each sample is a handful of float copies."""
        t = self.clock.monotonic()
        wall = self.clock.now().timestamp()
        touched = 0
        with self._lock:
            for registry, names in self._registries:
                try:
                    families = registry.families()
                except Exception:  # noqa: BLE001 — observation must
                    # never take down the observed
                    self.sample_errors += 1
                    continue
                for family in families:
                    if names is not None and family.name not in names:
                        continue
                    touched += self._sample_family(registry, family, t, wall)
            for provider in self._flat_providers:
                try:
                    flat = provider()
                except Exception:  # noqa: BLE001
                    self.sample_errors += 1
                    continue
                for (name, kind), value in flat.items():
                    if kind not in ("counter", "gauge"):
                        continue
                    self._get_series(name, name, kind).append(
                        t, wall, float(value)
                    )
                    touched += 1
            for name, kind, fn in self._providers:
                try:
                    value = float(fn())
                except Exception:  # noqa: BLE001
                    self.sample_errors += 1
                    continue
                self._get_series(name, name, kind).append(t, wall, value)
                touched += 1
            self.ticks += 1
        return touched

    def _sample_family(self, registry, family, t: float, wall: float) -> int:
        full = registry.full_name(family.name)
        touched = 0
        if isinstance(family, HistogramFamily):
            les = tuple(family.buckets) + (_INF,)
            with family._lock:
                values = {
                    key: (list(v[0]), float(v[1][0]), float(v[1][1]))
                    for key, v in family._values.items()
                }
            for key, (counts, hsum, hcount) in values.items():
                acc, cum = 0.0, []
                for c in counts:
                    acc += c
                    cum.append(acc)
                sample: HistSample = (les, tuple(cum), hsum, hcount)
                series = self._get_series(
                    self._series_name(full, family.labelnames, key),
                    full, "histogram",
                )
                series.append(t, wall, sample)
                touched += 1
        else:
            with family._lock:
                values = dict(family._values)
            for key, value in values.items():
                series = self._get_series(
                    self._series_name(full, family.labelnames, key),
                    full, family.kind,
                )
                series.append(t, wall, float(value))
                touched += 1
        return touched

    @staticmethod
    def _series_name(full, labelnames, labelvalues) -> str:
        if not labelnames:
            return full
        return f"{full}{{{_label_str(labelnames, labelvalues)}}}"

    # -- background ticker ---------------------------------------------------

    def start(self, interval_s: float = 5.0) -> None:
        """Tick on a daemon thread every interval_s until stop()."""
        if self._ticker is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                self.tick()

        self._ticker = threading.Thread(
            target=run, name="metric-history", daemon=True
        )
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        ticker, self._ticker = self._ticker, None
        if ticker is not None:
            ticker.join(timeout=5.0)

    # -- windowed queries ----------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _resolve(self, name: str) -> List[_Series]:
        """Exact series-key match, else every series of the family —
        summing a family's labeled children is valid for counters and
        cumulative bucket vectors (the never-average rule's whole
        point), so multi-child queries aggregate."""
        with self._lock:
            series = self._series.get(name)
            if series is not None:
                return [series]
            return [s for s in self._series.values() if s.family == name]

    def samples(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> List[tuple]:
        """(t, wall, value) samples with t >= now - window_s, oldest
        first, summed across the family's series when `name` names a
        labeled family. Single-series names return raw samples."""
        if now is None:
            now = self.clock.monotonic()
        cutoff = now - window_s
        matched = self._resolve(name)
        if not matched:
            return []
        with self._lock:
            per_series = [
                [s for s in series.snapshot() if s[0] >= cutoff]
                for series in matched
            ]
        per_series = [s for s in per_series if s]
        if not per_series:
            return []
        if len(per_series) == 1:
            return per_series[0]
        # multi-child family: align on tick timestamps and sum
        return _sum_aligned(per_series)

    def latest(self, name: str):
        """The newest sample's value, or None."""
        samples = self.samples(name, _INF)
        return samples[-1][2] if samples else None

    def delta(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """last - first over the window (counter increase; histogram
        count increase). A negative difference means the source reset
        (restart): fall back to the last value, Prometheus-style.
        None when the window holds < 2 samples."""
        samples = self.samples(name, window_s, now=now)
        if len(samples) < 2:
            return None
        first, last = _scalar(samples[0][2]), _scalar(samples[-1][2])
        d = last - first
        return last if d < 0 else d

    def rate(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """delta / elapsed, per second. None when the window holds
        < 2 samples or no time elapsed between them."""
        samples = self.samples(name, window_s, now=now)
        if len(samples) < 2:
            return None
        elapsed = samples[-1][0] - samples[0][0]
        if elapsed <= 0:
            return None
        d = self.delta(name, window_s, now=now)
        return None if d is None else d / elapsed

    def bucket_delta(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        """Cumulative (le, count) pairs for the observations that
        landed *inside* the window: the bucket vectors at the window
        edges, differenced. Per-bucket negative differences clamp to
        zero (counter reset). Empty when < 2 samples."""
        samples = self.samples(name, window_s, now=now)
        if len(samples) < 2:
            return []
        first, last = samples[0][2], samples[-1][2]
        if not isinstance(first, tuple) or not isinstance(last, tuple):
            return []
        les_a, counts_a = first[0], first[1]
        les_b, counts_b = last[0], last[1]
        if les_a != les_b:
            # bucket schema changed mid-window (re-registration);
            # the diff is meaningless — treat the window as empty
            return []
        return [
            (le, max(0.0, b - a))
            for le, a, b in zip(les_b, counts_a, counts_b)
        ]

    def quantile_over_window(
        self,
        name: str,
        q: float,
        window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Estimated q-quantile of the observations that landed inside
        the window: histogram_quantile over the edge-differenced
        cumulative vectors. None when the window saw no observations."""
        pairs = self.bucket_delta(name, window_s, now=now)
        if not pairs or pairs[-1][1] <= 0:
            return None
        return histogram_quantile(q, pairs)

    def bad_fraction(
        self,
        name: str,
        threshold: float,
        window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Fraction of the window's observations above `threshold`
        (aligned to a bucket edge; the nearest edge >= threshold is
        used). The burn-rate numerator. None when the window saw no
        observations."""
        pairs = self.bucket_delta(name, window_s, now=now)
        if not pairs:
            return None
        total = pairs[-1][1]
        if total <= 0:
            return None
        good = 0.0
        for le, count in pairs:
            if le >= threshold:
                good = count
                break
        return max(0.0, min(1.0, (total - good) / total))

    def describe(self, window_s: float = 300.0) -> List[Dict]:
        """Per-series summary rows for /debug/historyz."""
        now = self.clock.monotonic()
        with self._lock:
            names = sorted(self._series)
        out = []
        for name in names:
            with self._lock:
                series = self._series.get(name)
                if series is None:
                    continue
                snap = series.snapshot()
                kind = series.kind
            row: Dict = {
                "series": name,
                "kind": kind,
                "samples": len(snap),
                "total_sampled": series._seq,
            }
            if snap:
                row["age_s"] = round(now - snap[-1][0], 3)
                if kind == "histogram":
                    row["count"] = snap[-1][2][3]
                    for q in (0.5, 0.95, 0.99):
                        v = self.quantile_over_window(
                            name, q, window_s, now=now
                        )
                        if v is not None:
                            row[f"p{int(q * 100)}"] = round(v, 6)
                else:
                    row["latest"] = snap[-1][2]
                if kind in ("counter", "histogram"):
                    r = self.rate(name, window_s, now=now)
                    if r is not None:
                        row["rate"] = round(r, 6)
            out.append(row)
        return out


def _scalar(value) -> float:
    """A sample's scalar face: the value itself, or a histogram
    sample's observation count."""
    if isinstance(value, tuple):
        return float(value[3])
    return float(value)


def _sum_aligned(per_series: List[List[tuple]]) -> List[tuple]:
    """Sum samples across a family's children, aligned on the tick
    timestamp (children sampled in one tick() share t exactly).
    Scalars add; histogram samples add per-bucket when the bucket
    schemas agree."""
    by_t: Dict[float, List[tuple]] = {}
    for samples in per_series:
        for s in samples:
            by_t.setdefault(s[0], []).append(s)
    out = []
    for t in sorted(by_t):
        group = by_t[t]
        first = group[0]
        if isinstance(first[2], tuple):
            les = first[2][0]
            if any(s[2][0] != les for s in group[1:]):
                continue
            counts = tuple(
                sum(s[2][1][i] for s in group) for i in range(len(les))
            )
            hsum = sum(s[2][2] for s in group)
            hcount = sum(s[2][3] for s in group)
            out.append((t, first[1], (les, counts, hsum, hcount)))
        else:
            out.append((t, first[1], sum(float(s[2]) for s in group)))
    return out


# -- /debug/historyz ---------------------------------------------------------

def render_historyz(history: MetricHistory, query: str = "") -> bytes:
    """The shared /debug/historyz page: one JSON document. Params:
    `series=` filters to series whose key or family matches, `window=`
    sets the query window in seconds (default 300), `q=` adds that
    quantile for histogram series, `points=1` inlines the raw samples
    of the matched series (scalar series only get (t, value) pairs;
    histogram points carry count + the window quantile)."""
    from urllib.parse import parse_qs, unquote

    params = parse_qs(query or "", keep_blank_values=False)

    def first(name: str) -> Optional[str]:
        values = params.get(name)
        return values[0] if values else None

    window = 300.0
    raw = first("window")
    if raw:
        try:
            window = max(1.0, float(raw))
        except ValueError:
            pass
    want = first("series")
    if want:
        want = unquote(want)
    q = None
    raw = first("q")
    if raw:
        try:
            q = min(1.0, max(0.0, float(raw)))
        except ValueError:
            q = None

    rows = history.describe(window_s=window)
    if want:
        rows = [
            r for r in rows
            if r["series"] == want or r["series"].startswith(want)
        ]
    if q is not None:
        for row in rows:
            if row["kind"] != "histogram":
                continue
            v = history.quantile_over_window(row["series"], q, window)
            if v is not None:
                row[f"p{q * 100:g}"] = round(v, 6)
    doc: Dict = {
        "now_mono": round(history.clock.monotonic(), 3),
        "window_s": window,
        "capacity": history.capacity,
        "ticks": history.ticks,
        "sample_errors": history.sample_errors,
        "series": rows,
    }
    if first("points") == "1" and want:
        points: Dict[str, List] = {}
        for row in rows:
            samples = history.samples(row["series"], window)
            if row["kind"] == "histogram":
                points[row["series"]] = [
                    [round(t, 3), v[3]] for t, _, v in samples
                ]
            else:
                points[row["series"]] = [
                    [round(t, 3), v] for t, _, v in samples
                ]
        doc["points"] = points
    return (json.dumps(doc, indent=1) + "\n").encode()
