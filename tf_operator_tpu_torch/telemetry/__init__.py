"""The port's copy of the telemetry core the trainer and the decode
server feed (tf_operator_tpu/telemetry/): the labeled metric registry and
its text exposition, the span tracer, the flight recorder, trace context,
the metric history and the alert rules over it, the sampling profiler and
the step-window device profiler.

`default_registry()` is the process-wide registry for components without
an obvious owner (the Trainer), prefixed "tf_operator_tpu" as the
reference's is, so a trainer's series render under the reference's names
(`tf_operator_tpu_train_steps_total`). Registration is get-or-create, so
any number of instances can feed the same families.
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
from .alerts import (
    AlertManager,
    BurnRateRule,
    ThresholdRule,
    fleet_rules,
    render_alertz,
    serve_replica_rules,
    train_rules,
)
from .flight import (
    FlightRecord,
    FlightRecorder,
    correlate,
    current_correlation,
    default_flight,
    flight_record,
    render_flightz,
    set_default_flight,
)
from .history import MetricHistory, render_historyz
from .profiler import (
    ProfileSample,
    SamplingProfiler,
    default_profiler,
    render_profilez,
    set_default_profiler,
)
from .tracing import Span, SpanTracer

__all__ = [
    "ExpositionError", "bucket_pairs", "parse_text", "quantile_from_flat",
    "validate_text", "FAST_BUCKETS", "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "STEP_BUCKETS", "TTFT_BUCKETS", "MetricRegistry", "format_value",
    "histogram_quantile", "Span", "SpanTracer", "default_registry",
    "AlertManager", "BurnRateRule", "ThresholdRule", "fleet_rules", "render_alertz",
    "serve_replica_rules", "train_rules", "FlightRecord", "FlightRecorder",
    "correlate", "current_correlation", "default_flight", "flight_record",
    "render_flightz", "set_default_flight", "MetricHistory", "render_historyz",
    "ProfileSample", "SamplingProfiler", "default_profiler", "render_profilez",
    "set_default_profiler",
]

_default_lock = threading.Lock()
_default: MetricRegistry = None  # type: ignore[assignment]


def default_registry() -> MetricRegistry:
    """The process-wide registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry("tf_operator_tpu")
        return _default
