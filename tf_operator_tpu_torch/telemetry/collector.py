"""Fleet trace collector: one merged cross-process timeline per trace.

A routed request's flight records are scattered across processes —
the router's (route/pick/migrate), the prefill replica's (/prefill
handler, prefill chunks, kv-export), the decode replica's (kv-import,
admit, first-token) — each stamped with the fleet trace id
(telemetry/tracecontext.py) but timed on its OWN monotonic clock.
This module joins them:

- `clock_offset()` — the per-replica handshake: sample /debug/clockz
  a few times, keep the min-RTT sample, and map the replica's
  monotonic axis onto the collector's (offset error <= RTT/2).
- `collect_trace()` — fan out /debug/flightz?trace=<id> to every
  replica, normalize clocks, dedupe (in-process fleets share one ring
  across their servers), order the hop-boundary events, and emit the
  per-hop TTFT decomposition plus a Perfetto timeline.

The hop vocabulary (the TTFT decomposition), contiguous by
construction so the hops sum to the route->first-token interval:

    disaggregated (migrated) requests:
      queue_wait     route            -> pick             (router)
      route_decision pick             -> /prefill request (hop out)
      prefill        /prefill request -> prefill evict    (prefill)
      kv_export      prefill evict    -> kv-export        (prefill)
      transfer       kv-export        -> /kv/import req   (hop out)
      kv_import      /kv/import req   -> kv-import        (decode)
      decode_admit   kv-import        -> admit            (decode)
      first_token    admit            -> first-token      (decode)

    monolithic requests: queue_wait, route_decision (pick -> stream
    request), decode_admit (stream request -> admit), first_token.

Boundary events are grouped by their server-side correlation ID (each
hop's handler binds its own req-N), NOT by which replica served the
fetch — an in-process fleet's servers all share one flight ring, so
source identity can't disambiguate but corr always does.

Orphans: any trace-stamped record whose op is outside the known
vocabulary. A new op added to the serve path without collector
support shows up here (and fails trace-smoke) instead of silently
vanishing from timelines.

Stdlib only; the only I/O is through the injected client objects
(serve/client.py DecodeClient or anything with the same 3 methods).

The port's copy of tf_operator_tpu/telemetry/collector.py; it imports nothing of that package.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "clock_offset",
    "ClockCache",
    "collect_trace",
    "collect_history",
    "collect_alerts",
    "hop_breakdown",
    "KNOWN_OPS",
    "HOP_NAMES",
]

# every op the serve planes stamp with a trace id; a trace-carrying
# record outside this set is an orphan (see module docstring)
_BOUNDARY_OPS = frozenset({
    "route", "pick", "request", "evict", "kv-export", "kv-import",
    "admit", "first-token",
})
_ANCILLARY_OPS = frozenset({
    "submit", "kv-plan", "prefill-chunk", "step", "migrate",
    "migrate-failed", "failover", "route-done", "serve-sync",
    # re-prefill waste attribution (router _attribute_waste): one
    # trace-stamped record per placed stream whose prefix was warmer
    # on some peer than on the chosen replica
    "kvwaste",
})
KNOWN_OPS = _BOUNDARY_OPS | _ANCILLARY_OPS

HOP_NAMES = (
    "queue_wait", "route_decision", "prefill", "kv_export",
    "transfer", "kv_import", "decode_admit", "first_token",
)

# post-normalization boundaries may disorder by up to the handshake
# error (RTT/2 per side); clamping fixes the order, and anything past
# this bound means the handshake itself is broken, not jitter
MAX_CLAMP_S = 0.25


class ClockMap(NamedTuple):
    """Replica-to-collector clock mapping from one min-RTT handshake
    sample: local = remote_mono + offset_mono (flight records), and
    local = remote_perf + offset_perf (span timestamps)."""

    offset_mono: float
    offset_perf: float
    rtt: float


def clock_offset(client, samples: int = 3) -> ClockMap:
    """Handshake with one replica's /debug/clockz: `samples` round
    trips, keep the one with the smallest RTT (its midpoint bounds the
    offset error by RTT/2 — NTP's intersection trick, minus the
    machinery)."""
    best: Optional[ClockMap] = None
    for _ in range(max(1, int(samples))):
        t0 = time.monotonic()
        page = client.clockz()
        t1 = time.monotonic()
        rtt = t1 - t0
        mid = (t0 + t1) / 2.0
        cm = ClockMap(
            offset_mono=mid - float(page["mono"]),
            offset_perf=mid - float(page["perf"]),
            rtt=rtt,
        )
        if best is None or cm.rtt < best.rtt:
            best = cm
    return best


class ClockCache:
    """Per-replica ClockMap cache with a TTL and RTT-degrade
    invalidation.

    The handshake costs `samples` /debug/clockz round-trips per
    replica; a tracez invocation over an N-replica fleet used to pay
    N*samples of them EVERY call even though a process's monotonic
    offset only changes on restart. The cache keeps each replica's
    min-RTT handshake until it goes stale (ttl_s) — or until the
    network it was measured on visibly degrades: callers report each
    later fetch's round-trip through observe_rtt(), and a fetch
    taking far longer than the cached handshake's RTT (degrade_factor
    x, past an absolute floor) means the cached offset error bound no
    longer holds, so the entry is dropped and the next get()
    re-handshakes."""

    def __init__(
        self,
        ttl_s: float = 30.0,
        samples: int = 3,
        degrade_factor: float = 3.0,
        degrade_floor_s: float = 0.05,
        clock=time.monotonic,
    ) -> None:
        self.ttl_s = float(ttl_s)
        self.samples = int(samples)
        self.degrade_factor = float(degrade_factor)
        self.degrade_floor_s = float(degrade_floor_s)
        self._clock = clock
        # name -> (ClockMap, acquired_at)
        self._entries: Dict[str, Tuple[ClockMap, float]] = {}
        # name -> last observed per-process epoch counter (see
        # observe_epoch): a monotone counter going BACKWARDS means the
        # process restarted, and its monotonic clock (and therefore
        # the cached offset) restarted with it
        self._epochs: Dict[str, float] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, name: str, client) -> ClockMap:
        """The replica's ClockMap: cached when fresh, re-handshaken
        when absent or stale."""
        now = self._clock()
        entry = self._entries.get(name)
        if entry is not None and now - entry[1] < self.ttl_s:
            self.hits += 1
            return entry[0]
        self.misses += 1
        cm = clock_offset(client, samples=self.samples)
        self._entries[name] = (cm, self._clock())
        return cm

    def observe_rtt(self, name: str, rtt_s: float) -> None:
        """Report a non-handshake round-trip to `name`. A fetch far
        slower than the cached handshake suggests the offset error
        bound (RTT/2) no longer describes the path; invalidate so the
        next get() re-measures."""
        entry = self._entries.get(name)
        if entry is None:
            return
        bound = max(
            self.degrade_factor * entry[0].rtt, self.degrade_floor_s
        )
        if rtt_s > bound:
            del self._entries[name]
            self.invalidations += 1

    def observe_epoch(self, name: str, value: float) -> None:
        """Report a per-process monotone counter scraped from `name`
        (the observatory passes engine_compiles_total). The counter
        only ever grows within one process lifetime, so a DROP means
        the replica restarted: its monotonic clock reset, the cached
        offset is garbage, and the entry is invalidated so the next
        get() re-handshakes against the new process."""
        prev = self._epochs.get(name)
        self._epochs[name] = float(value)
        if prev is None or float(value) >= prev:
            return
        if name in self._entries:
            del self._entries[name]
            self.invalidations += 1

    def invalidate(self, name: Optional[str] = None) -> None:
        if name is None:
            self._entries.clear()
        else:
            self._entries.pop(name, None)

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "invalidations": self.invalidations,
        }


def _dedupe(records: List[dict]) -> List[dict]:
    """Drop identical records fetched through different servers of one
    process (an in-process fleet shares a single flight ring): the
    (seq, wall, kind, corr) tuple identifies a ring slot exactly."""
    seen = set()
    out = []
    for r in records:
        key = (
            r.get("seq"), r.get("wall"), r.get("kind"), r.get("corr"),
            json.dumps(r.get("fields"), sort_keys=True, default=str),
        )
        if key in seen:
            continue
        seen.add(key)
        out.append(r)
    return out


def _groups(records: List[dict]) -> Dict[str, List[dict]]:
    by_corr: Dict[str, List[dict]] = {}
    for r in records:
        by_corr.setdefault(str(r.get("corr")), []).append(r)
    for rows in by_corr.values():
        rows.sort(key=lambda r: r["t"])
    return by_corr


def _find(rows: List[dict], op: str, path: Optional[str] = None,
          last: bool = False) -> Optional[dict]:
    hits = [
        r for r in rows
        if r["fields"].get("op") == op
        and (path is None or r["fields"].get("path") == path)
    ]
    if not hits:
        return None
    return hits[-1] if last else hits[0]


def hop_breakdown(records: List[dict]) -> dict:
    """The per-hop TTFT decomposition over clock-normalized records
    (each record's "t" already on one axis). Returns {"mode", "hops":
    [{"name", "start_s", "end_s", "duration_s"}...], "ttft_s",
    "clamped_s", "missing": [boundary...]}; hops are contiguous, so
    sum(duration) == ttft_s when nothing is missing."""
    groups = _groups(records)
    router_rows: List[dict] = []
    prefill_rows: List[dict] = []
    import_rows: List[dict] = []
    decode_rows: List[dict] = []
    for rows in groups.values():
        if _find(rows, "route") is not None:
            router_rows = rows
        elif _find(rows, "request", path="/prefill") is not None:
            prefill_rows = rows
        elif _find(rows, "request", path="/kv/import") is not None:
            import_rows = rows
        elif _find(rows, "request", path="/generate_stream") is not None:
            decode_rows = rows

    migrated = bool(prefill_rows) and bool(import_rows)
    # boundary instants, in hop order. "pick" takes the LAST one: a
    # pre-first-byte failover re-picks, and the replica that actually
    # served the stream is the one whose hops we time.
    if migrated:
        plan: List[Tuple[str, Optional[dict]]] = [
            ("route", _find(router_rows, "route")),
            ("pick", _find(router_rows, "pick", last=True)),
            ("prefill_request",
             _find(prefill_rows, "request", path="/prefill")),
            ("prefill_done", _find(prefill_rows, "evict")),
            ("kv_export", _find(prefill_rows, "kv-export")),
            ("import_request",
             _find(import_rows, "request", path="/kv/import")),
            ("kv_import", _find(import_rows, "kv-import")),
            ("admit", _find(decode_rows, "admit")),
            ("first_token", _find(decode_rows, "first-token")),
        ]
        hop_names = HOP_NAMES
    else:
        plan = [
            ("route", _find(router_rows, "route")),
            ("pick", _find(router_rows, "pick", last=True)),
            ("stream_request",
             _find(decode_rows, "request", path="/generate_stream")),
            ("admit", _find(decode_rows, "admit")),
            ("first_token", _find(decode_rows, "first-token")),
        ]
        hop_names = (
            "queue_wait", "route_decision", "decode_admit", "first_token",
        )

    missing = [name for name, r in plan if r is None]
    present = [(name, float(r["t"])) for name, r in plan if r is not None]
    # monotone clamp: handshake error can disorder boundaries by up to
    # RTT/2 per clock; the hop model is contiguous-by-construction, so
    # clamp forward and report how much adjustment that took
    clamped = 0.0
    times: List[Tuple[str, float]] = []
    for name, t in present:
        if times and t < times[-1][1]:
            clamped += times[-1][1] - t
            t = times[-1][1]
        times.append((name, t))
    hops = []
    if not missing and len(times) == len(plan):
        for i, hop in enumerate(hop_names):
            start = times[i][1]
            end = times[i + 1][1]
            hops.append({
                "name": hop,
                "start_s": round(start, 6),
                "end_s": round(end, 6),
                "duration_s": round(end - start, 6),
            })
    ttft = (
        times[-1][1] - times[0][1]
        if len(times) >= 2 and times[-1][0] == "first_token"
        and times[0][0] == "route" else None
    )
    return {
        "mode": "disaggregated" if migrated else "monolithic",
        "hops": hops,
        "ttft_s": round(ttft, 6) if ttft is not None else None,
        "clamped_s": round(clamped, 6),
        "missing": missing,
    }


def _perfetto(records: List[dict], breakdown: dict,
              origin: float) -> List[dict]:
    """traceEvents: one "X" complete event per hop on a dedicated
    track, plus one instant per record on a per-source track — ts in
    microseconds since the trace's first boundary."""

    def us(t: float) -> float:
        return round((t - origin) * 1e6, 3)

    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0,
        "args": {"name": "fleet-trace"},
    }, {
        "name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
        "args": {"name": "hops"},
    }]
    for hop in breakdown["hops"]:
        events.append({
            "name": hop["name"], "cat": "hop", "ph": "X",
            "ts": us(hop["start_s"]),
            "dur": round(hop["duration_s"] * 1e6, 3),
            "pid": 0, "tid": 1,
        })
    tracks: Dict[str, int] = {}
    for r in records:
        source = str(r.get("source", "?"))
        tid = tracks.setdefault(source, 2 + len(tracks))
        fields = dict(r.get("fields") or {})
        name = str(r.get("kind", "record"))
        op = fields.get("op")
        if op:
            name = f"{name}:{op}"
        if r.get("corr") is not None:
            fields["corr"] = r["corr"]
        events.append({
            "name": name, "cat": "flight", "ph": "i",
            "ts": us(float(r["t"])), "pid": 0, "tid": tid,
            "s": "t", "args": fields,
        })
    for source, tid in tracks.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": source},
        })
    return events


def collect_trace(
    trace_id: str,
    replicas: Dict[str, object],
    local_records: Optional[List[dict]] = None,
    local_name: str = "router",
    handshake_samples: int = 3,
    clock_cache: Optional[ClockCache] = None,
) -> dict:
    """Fan out to every replica, merge, decompose. `replicas` maps
    name -> client (DecodeClient API: clockz(), flightz(trace=)).
    `local_records` are this process's own matching records (already
    on the local clock — the router process passes its flight ring's
    snapshot through FlightRecord.to_dict()).

    `clock_cache` reuses handshakes across calls (ClockCache): the
    flightz fetch's own round-trip is reported back to the cache, so
    a degraded path invalidates the entry it was measured on. None
    keeps the historical handshake-every-call behavior.

    Returns {"trace", "records" (normalized, source-tagged, time-
    ordered), "breakdown" (hop_breakdown), "orphans", "replicas":
    {name: {"rtt_s", "offset_s"}}, "perfetto": {"traceEvents": ...}}.
    """
    merged: List[dict] = []
    for r in (local_records or []):
        row = dict(r)
        row["source"] = local_name
        merged.append(row)
    handshakes: Dict[str, ClockMap] = {}
    fetched: List[dict] = []
    for name, client in replicas.items():
        if clock_cache is not None:
            cm = clock_cache.get(name, client)
        else:
            cm = clock_offset(client, samples=handshake_samples)
        handshakes[name] = cm
        f0 = time.monotonic()
        rows = client.flightz(trace=trace_id)
        if clock_cache is not None:
            clock_cache.observe_rtt(name, time.monotonic() - f0)
        for r in rows:
            row = dict(r)
            row["source"] = name
            row["t_raw"] = row["t"]
            row["t"] = float(row["t"]) + cm.offset_mono
            fetched.append(row)
    # dedupe local + fetched TOGETHER: an in-process fleet's servers
    # (and its router) all share one flight ring, so the same ring
    # slot arrives once per fetch path. Local copies are listed first
    # and win — their clock is exact, fetched ones carry handshake
    # error.
    merged.extend(fetched)
    merged = _dedupe(merged)
    merged = [
        r for r in merged
        if (r.get("fields") or {}).get("trace") == trace_id
    ]
    merged.sort(key=lambda r: r["t"])
    breakdown = hop_breakdown(merged)
    if breakdown["clamped_s"] > MAX_CLAMP_S:
        breakdown["clock_warning"] = (
            f"monotone clamp moved boundaries {breakdown['clamped_s']}s "
            f"(> {MAX_CLAMP_S}s): clock handshake unreliable"
        )
    orphans = [
        r for r in merged
        if (r.get("fields") or {}).get("op") not in KNOWN_OPS
    ]
    origin = merged[0]["t"] if merged else 0.0
    return {
        "trace": trace_id,
        "records": merged,
        "breakdown": breakdown,
        "orphans": orphans,
        "replicas": {
            name: {
                "rtt_s": round(cm.rtt, 6),
                "offset_s": round(cm.offset_mono, 6),
            }
            for name, cm in handshakes.items()
        },
        "perfetto": {
            "traceEvents": _perfetto(merged, breakdown, origin),
            "displayTimeUnit": "ms",
        },
    }


def collect_history(
    replicas: Dict[str, object],
    series: Optional[str] = None,
    window_s: float = 300.0,
    q: Optional[float] = None,
) -> dict:
    """Fan /debug/historyz out to every replica (DecodeClient API:
    historyz()). Per-replica pages come back keyed by replica name;
    scrape failures are collected, not raised, so one dead replica
    doesn't hide the rest of the fleet's history."""
    pages: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    for name, client in replicas.items():
        try:
            pages[name] = client.historyz(
                series=series, window=window_s, q=q
            )
        except Exception as err:  # noqa: BLE001 — a fleet page must
            # survive any one replica's failure mode
            errors[name] = str(err)
    return {
        "series": series,
        "window_s": window_s,
        "replicas": pages,
        "scrape_errors": errors,
        "partial": bool(errors),
    }


def collect_alerts(replicas: Dict[str, object]) -> dict:
    """Fan /debug/alertz out to every replica; same partial-tolerant
    shape as collect_history."""
    pages: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    for name, client in replicas.items():
        try:
            pages[name] = client.alertz()
        except Exception as err:  # noqa: BLE001
            errors[name] = str(err)
    firing = sorted({
        inst
        for page in pages.values()
        for inst in page.get("firing", [])
    })
    return {
        "replicas": pages,
        "firing": firing,
        "scrape_errors": errors,
        "partial": bool(errors),
    }
