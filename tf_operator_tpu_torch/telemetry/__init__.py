"""The port's copy of the telemetry core the trainer and the decode
server feed (tf_operator_tpu/telemetry/): the labeled metric registry and
its text exposition, the span tracer, the flight recorder, trace context
and the step-window device profiler.

`default_registry()` is the process-wide registry for components without
an obvious owner (the Trainer): registration is get-or-create, so any
number of instances can feed the same families.
"""

from __future__ import annotations

import threading

from .exposition import (
    ExpositionError,
    bucket_pairs,
    parse_text,
    quantile_from_flat,
    validate_text,
)
from .registry import (
    FAST_BUCKETS,
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    STEP_BUCKETS,
    TTFT_BUCKETS,
    MetricRegistry,
    format_value,
    histogram_quantile,
)
from .tracing import Span, SpanTracer

__all__ = [
    "ExpositionError", "bucket_pairs", "parse_text", "quantile_from_flat",
    "validate_text", "FAST_BUCKETS", "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "STEP_BUCKETS", "TTFT_BUCKETS", "MetricRegistry", "format_value",
    "histogram_quantile", "Span", "SpanTracer", "default_registry",
]

_default_lock = threading.Lock()
_default: MetricRegistry = None  # type: ignore[assignment]


def default_registry() -> MetricRegistry:
    """The process-wide registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default
