"""Flight recorder: the port's copy of the ring buffer of
tf_operator_tpu/telemetry/flight.py that the trainer records into.

A preallocated, bounded ring of typed records (trainer step stats,
checkpoint saves, preemptions, step-phase splits). Recording is one clock
read and one slot store under a lock; a disabled recorder returns before
touching the lock. Each record carries the correlation id bound by
`correlate()` (the server's request id), and a bound trace context
(tracecontext.trace_scope) lands in its fields as "trace"/"span".
`render_flightz` is the /debug/flightz page the decode server and the
trainer telemetry server serve. The reference's crash and SIGUSR2 dumps
are not part of this copy.
"""

from __future__ import annotations

import contextvars
import json
import time
from typing import Any, Dict, List, NamedTuple, Optional

from ..utils import locks
from .tracecontext import current_trace

__all__ = [
    "FlightRecord", "FlightRecorder", "correlate", "current_correlation",
    "default_flight", "set_default_flight", "flight_record", "render_flightz",
]

_correlation: contextvars.ContextVar = contextvars.ContextVar(
    "telemetry_correlation_id", default=None
)


def current_correlation() -> Optional[str]:
    """The correlation ID bound to the current context, or None."""
    return _correlation.get()


class correlate:
    """Bind a correlation ID for a block::

        with correlate("req-7"):
            ...  # spans begun here carry it

    Nests: the previous binding is restored on exit. A None id binds
    nothing new."""

    __slots__ = ("corr", "_token")

    def __init__(self, corr) -> None:
        self.corr = None if corr is None else str(corr)

    def __enter__(self) -> Optional[str]:
        if self.corr is None:
            self._token = None
            return _correlation.get()
        self._token = _correlation.set(self.corr)
        return self.corr

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _correlation.reset(self._token)


class FlightRecord(NamedTuple):
    """One ring entry. `t` is monotonic seconds (ordering and deltas),
    `wall` is epoch seconds (joining records across processes)."""

    seq: int
    t: float
    wall: float
    kind: str
    corr: Optional[str]
    fields: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "t": round(self.t, 6),
            "wall": round(self.wall, 6),
            "kind": self.kind,
            "corr": self.corr,
            "fields": {k: _jsonable(v) for k, v in self.fields.items()},
        }


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


class FlightRecorder:
    """Bounded ring of FlightRecords. Thread-safe; overwrite-oldest."""

    def __init__(
        self, capacity: int = 4096, clock=time.monotonic, enabled: bool = True,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = locks.make_lock("FlightRecorder._lock")
        self._buf: List[Optional[FlightRecord]] = [None] * self.capacity
        self._seq = 0

    def record(self, kind: str, corr: Optional[str] = None, **fields) -> Optional[FlightRecord]:
        """Append one record; -> it, or None when disabled. corr defaults
        to the context's `correlate()` binding; an explicit trace= field
        wins over the bound trace context (threads outside the request
        context, such as the engine's, pass the trace captured at
        submit)."""
        if not self.enabled:
            return None
        if corr is None:
            corr = _correlation.get()
        if fields.get("trace") is None:
            ctx = current_trace()
            if ctx is not None:
                fields["trace"] = ctx.trace_id
                fields["span"] = ctx.span_id
            elif "trace" in fields:
                del fields["trace"]
        t = self._clock()
        wall = time.time()
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            record = FlightRecord(seq, t, wall, kind, corr, fields)
            self._buf[seq % self.capacity] = record
        return record

    def snapshot(
        self, kind: Optional[str] = None, corr: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[FlightRecord]:
        """Records in the ring, oldest first, optionally of one kind
        and/or correlation id; `limit` keeps the newest N after
        filtering."""
        with self._lock:
            seq = self._seq
            buf = list(self._buf)
        start = max(0, seq - self.capacity)
        records = [
            r for i in range(start, seq) if (r := buf[i % self.capacity]) is not None
        ]
        if kind is not None:
            records = [r for r in records if r.kind == kind]
        if corr is not None:
            records = [r for r in records if r.corr == corr]
        if limit is not None and limit > 0:
            records = records[-limit:]
        return records


_default = FlightRecorder()


def default_flight() -> FlightRecorder:
    """The process-wide recorder every component records into by default."""
    return _default


def set_default_flight(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide recorder (tests isolate through this)."""
    global _default
    _default = recorder
    return recorder


def flight_record(kind: str, corr: Optional[str] = None, **fields) -> Optional[FlightRecord]:
    """record() on the process-wide default recorder."""
    return _default.record(kind, corr=corr, **fields)


def render_flightz(recorder: FlightRecorder, query: str = "") -> bytes:
    """The /debug/flightz page: JSONL, one record per line, filtered by
    query-string params: `corr=` (alias `request=`) on the correlation
    id, `job=` on job-identifying fields or the corr, `kind=` on the
    record kind, `trace=` on the trace id in fields, `since=<unix_ts>`
    keeps records whose wall clock is at or after it, `limit=` keeps the
    newest N."""
    from urllib.parse import parse_qs

    params = parse_qs(query or "", keep_blank_values=False)

    def first(name: str) -> Optional[str]:
        values = params.get(name)
        return values[0] if values else None

    def number(name: str, cast):
        raw = first(name)
        if not raw:
            return None
        try:
            return cast(raw)
        except ValueError:
            return None

    job = first("job")
    trace = first("trace")
    since = number("since", float)
    limit = number("limit", int)
    records = recorder.snapshot(kind=first("kind"), corr=first("corr") or first("request"))
    if trace is not None:
        records = [r for r in records if r.fields.get("trace") == trace]
    if since is not None:
        records = [r for r in records if r.wall >= since]
    if job is not None:
        records = [
            r for r in records
            if r.corr == job or job in (r.fields.get("job"), r.fields.get("key"),
                                        r.fields.get("obj"))
        ]
    if limit is not None:
        records = records[-max(1, limit):]
    if not records:
        return b""
    return ("\n".join(json.dumps(r.to_dict()) for r in records) + "\n").encode()
