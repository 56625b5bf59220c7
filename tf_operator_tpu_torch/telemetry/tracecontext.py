"""W3C-style trace context: the port's copy of what the trainer and the
decode server use from tf_operator_tpu/telemetry/tracecontext.py.

`trace_scope()` binds a fresh trace id (and span id) for a block; every
flight record made inside carries them. `Trainer.save` stamps each
checkpoint publish with its own trace, and the Evaluator each
evaluation, so a checkpoint and the evaluation of it can be joined. The
decode server joins a request to its caller's trace through the
`traceparent` header (`parse_traceparent`), and the client sends one
for the ambient context (`trace_headers`).
"""

from __future__ import annotations

import contextvars
import os
import re
from typing import Dict, NamedTuple, Optional

__all__ = [
    "TRACEPARENT_HEADER", "TraceContext", "current_trace", "trace_scope",
    "new_trace_id", "new_span_id", "format_traceparent", "parse_traceparent",
    "trace_headers",
]

TRACEPARENT_HEADER = "traceparent"
# version 00: 32 hex trace id, 16 hex span id, 2 hex flags
_TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext(NamedTuple):
    """The trace id shared by every hop plus the span id of this one."""

    trace_id: str
    span_id: str


_trace: contextvars.ContextVar = contextvars.ContextVar(
    "telemetry_trace_context", default=None
)


def new_trace_id() -> str:
    """32 lowercase hex chars (128 random bits)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """16 lowercase hex chars (64 random bits)."""
    return os.urandom(8).hex()


def current_trace() -> Optional[TraceContext]:
    """The trace context bound in this execution context, or None."""
    return _trace.get()


class trace_scope:
    """Bind a trace context for a block::

        with trace_scope() as ctx:            # fresh trace
            ...
        with trace_scope(parent=incoming):    # same trace, child span

    Nests; the previous binding is restored on exit."""

    __slots__ = ("ctx", "_token")

    def __init__(
        self,
        parent: Optional[TraceContext] = None,
        trace_id: Optional[str] = None,
        span_id: Optional[str] = None,
    ) -> None:
        tid = trace_id or (parent.trace_id if parent else new_trace_id())
        self.ctx = TraceContext(tid, span_id or new_span_id())

    def __enter__(self) -> TraceContext:
        self._token = _trace.set(self.ctx)
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        _trace.reset(self._token)


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """The TraceContext a traceparent header carries, or None for a
    missing or malformed one (a bad header degrades to an untraced
    request, never a 500)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def trace_headers(
    base: Optional[Dict[str, str]] = None, ctx: Optional[TraceContext] = None,
) -> Dict[str, str]:
    """`base` plus a traceparent for the ambient (or given) trace
    context; with none bound, `base` unchanged."""
    headers = dict(base or {})
    if ctx is None:
        ctx = _trace.get()
    if ctx is not None:
        headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
    return headers
