"""The port's copy of the telemetry core the trainer feeds
(tf_operator_tpu/telemetry/): the labeled metric registry, the flight
recorder, trace context and the step-window device profiler.

`default_registry()` is the process-wide registry for components without
an obvious owner (the Trainer): registration is get-or-create, so any
number of instances can feed the same families.
"""

from __future__ import annotations

import threading

from .registry import STEP_BUCKETS, MetricRegistry

__all__ = ["STEP_BUCKETS", "MetricRegistry", "default_registry"]

_default_lock = threading.Lock()
_default: MetricRegistry = None  # type: ignore[assignment]


def default_registry() -> MetricRegistry:
    """The process-wide registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default
