"""Flight recorder: the port's copy of the ring buffer of
tf_operator_tpu/telemetry/flight.py that the trainer records into.

A preallocated, bounded ring of typed records (trainer step stats,
checkpoint saves, preemptions, step-phase splits). Recording is one clock
read and one slot store under a lock; a disabled recorder returns before
touching the lock. A bound trace context (tracecontext.trace_scope) lands
in each record's fields as "trace"/"span". The reference's crash dumps,
correlation ids and /debug/flightz page are not part of this copy.
"""

from __future__ import annotations

import contextvars
import time
from typing import Any, Dict, List, NamedTuple, Optional

from ..utils import locks
from .tracecontext import current_trace

__all__ = [
    "FlightRecord", "FlightRecorder", "correlate", "current_correlation",
    "default_flight", "set_default_flight", "flight_record",
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
    fields: Dict[str, Any]


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

    def record(self, kind: str, **fields) -> Optional[FlightRecord]:
        """Append one record; -> it, or None when disabled."""
        if not self.enabled:
            return None
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
            record = FlightRecord(seq, t, wall, kind, fields)
            self._buf[seq % self.capacity] = record
        return record

    def snapshot(
        self, kind: Optional[str] = None, limit: Optional[int] = None,
    ) -> List[FlightRecord]:
        """Records in the ring, oldest first, optionally of one kind;
        `limit` keeps the newest N after filtering."""
        with self._lock:
            seq = self._seq
            buf = list(self._buf)
        start = max(0, seq - self.capacity)
        records = [
            r for i in range(start, seq) if (r := buf[i % self.capacity]) is not None
        ]
        if kind is not None:
            records = [r for r in records if r.kind == kind]
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


def flight_record(kind: str, **fields) -> Optional[FlightRecord]:
    """record() on the process-wide default recorder."""
    return _default.record(kind, **fields)
