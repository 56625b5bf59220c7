"""Span tracer exporting Chrome/Perfetto trace-event JSON: the port's
copy of tf_operator_tpu/telemetry/tracing.py, which the decode engine's
request spans and the server's /debug/trace use.

Where the registry answers "how long do these take in aggregate", a
span answers "where did THIS request's time go": one span per unit of
work (a serve request, a TFJob's lifecycle), with named instants for
its phase transitions (queued -> admitted -> first-token ->
finished). Finished spans land in a bounded ring buffer, and
export_chrome() renders them as the trace-event JSON format both
chrome://tracing and https://ui.perfetto.dev load directly: `ph:"X"`
complete events (ts/dur in microseconds) for the spans and `ph:"i"`
instants for the phase marks.

Clock injection is explicit (the controller/clock.py pattern): pass
any zero-arg float-seconds callable — tests pass a fake and assert
exact microsecond arithmetic. The default is time.perf_counter;
timestamps are relative to the tracer's construction, which is what
trace viewers want anyway.

Thread-safety: begin()/finish() take the tracer lock; annotate()
appends under it too. Spans are cheap (a list of tuples), so tracing
stays on even in production — the ring bounds memory, not the rate.
"""

from __future__ import annotations

import contextvars
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils import locks

# process-wide span ids: log lines carry span_id (utils/logger.py) and
# join against the exported trace, so ids must be unique across tracers
_span_ids = itertools.count(1)

_active_span: contextvars.ContextVar = contextvars.ContextVar(
    "telemetry_active_span", default=None
)


def current_span() -> Optional["Span"]:
    """The innermost span entered (as a context manager) in the
    current context and not yet finished, or None."""
    span = _active_span.get()
    if span is not None and span.end is not None:
        return None
    return span


class Span:
    """One unit of traced work. Use as a context manager or call
    finish() explicitly; annotate() marks named phase instants."""

    __slots__ = (
        "name", "track", "args", "start", "end", "events", "id",
        "_tracer", "_token",
    )

    def __init__(self, tracer: "SpanTracer", name: str, track: int, args: dict):
        self._tracer = tracer
        self._token = None
        self.id = next(_span_ids)
        self.name = name
        self.track = track
        self.args = args
        self.start = tracer._now()
        self.end: Optional[float] = None
        self.events: List[tuple] = []  # (phase, t)

    def annotate(self, phase: str, **args) -> None:
        """Record a named instant at the current clock (idempotent per
        phase name: lifecycle observers can re-report a state without
        duplicating marks)."""
        tracer = self._tracer
        with tracer._lock:
            if self.end is not None:
                return
            if any(name == phase for name, _ in self.events):
                return
            self.events.append((phase, tracer._now()))
            if args:
                self.args.update(args)

    def finish(self, **args) -> None:
        tracer = self._tracer
        with tracer._lock:
            if self.end is not None:
                return  # double-finish is a no-op, not corruption
            if args:
                self.args.update(args)
            self.end = tracer._now()
            tracer._finished.append(self)

    @property
    def duration(self) -> Optional[float]:
        if self.end is None:
            return None
        return self.end - self.start

    def __enter__(self) -> "Span":
        self._token = _active_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _active_span.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.finish(outcome="error", error=exc_type.__name__)
        else:
            self.finish()


class SpanTracer:
    def __init__(
        self,
        clock=None,
        capacity: int = 512,
        process_name: str = "tf_operator_tpu",
    ) -> None:
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = locks.make_lock("SpanTracer._lock")
        self._epoch = float(self._clock())
        self._finished: deque = deque(maxlen=capacity)
        self._tracks = itertools.count(1)
        self.process_name = process_name

    def _now(self) -> float:
        """Seconds since the tracer's epoch."""
        return float(self._clock()) - self._epoch

    def begin(self, name: str, track: Optional[int] = None, **args) -> Span:
        """Open a span. Each span defaults to its own track (tid), so
        overlapping requests render as parallel rows in the viewer;
        pass track= to pin related spans to one row. A flight
        correlation ID active in this context (flight.correlate) lands
        in args["corr"] so spans join flight records and log lines; a
        bound trace context (tracecontext.trace_scope) lands in
        args["trace"] so the span joins its fleet-wide timeline."""
        if "corr" not in args:
            from .flight import current_correlation

            corr = current_correlation()
            if corr is not None:
                args["corr"] = corr
        if "trace" not in args:
            from .tracecontext import current_trace

            ctx = current_trace()
            if ctx is not None:
                args["trace"] = ctx.trace_id
        with self._lock:
            if track is None:
                track = next(self._tracks)
            return Span(self, name, int(track), dict(args))

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def export_chrome(self, pid: int = 0) -> Dict[str, list]:
        """{"traceEvents": [...]} — load in chrome://tracing or
        ui.perfetto.dev. Only finished spans are exported (an open
        span has no duration yet)."""

        def us(t: float) -> float:
            return round(t * 1e6, 3)

        events: List[dict] = [{
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": self.process_name},
        }]
        for span in self.finished_spans():
            events.append({
                "name": span.name,
                "cat": span.name,
                "ph": "X",
                "ts": us(span.start),
                "dur": us((span.end or span.start) - span.start),
                "pid": pid,
                "tid": span.track,
                "args": {
                    "span_id": span.id,
                    **{k: _jsonable(v) for k, v in span.args.items()},
                },
            })
            for phase, t in span.events:
                events.append({
                    "name": phase,
                    "cat": span.name,
                    "ph": "i",
                    "ts": us(t),
                    "pid": pid,
                    "tid": span.track,
                    "s": "t",  # thread-scoped instant
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)
