"""W3C-style trace context: the port's copy of what the trainer uses from
tf_operator_tpu/telemetry/tracecontext.py.

`trace_scope()` binds a fresh trace id (and span id) for a block; every
flight record made inside carries them. `Trainer.save` stamps each
checkpoint publish with its own trace, and the Evaluator each
evaluation, so a checkpoint and the evaluation of it can be joined.
"""

from __future__ import annotations

import contextvars
import os
from typing import NamedTuple, Optional

__all__ = ["TraceContext", "current_trace", "trace_scope", "new_trace_id", "new_span_id"]


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
