"""Runtime plumbing the port copies from tf_operator_tpu/runtime/: the
in-memory substrate and its watch events, pod control, the event
recorder, the expectations cache, the client-go work queues and the
retry policy (the reference's RetryingSubstrate is not copied). The reference's native queue (native_queue.py over
native/libtfoprt.so) is not copied: the port's controllers use the
pure-Python queue and expectations, the reference's own fallback."""

from .control import (
    FakePodControl,
    FakeServiceControl,
    RealPodControl,
    RealServiceControl,
    is_controlled_by,
    owner_reference,
)
from .events import EventRecorder, NullRecorder
from .expectations import ControllerExpectations
from .retry import RetryPolicy, call_with_retries, is_transient_error
from .substrate import (
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExists,
    Conflict,
    FencedWrite,
    InMemorySubstrate,
    NotFound,
    Substrate,
    match_labels,
    now_iso,
)
from .workqueue import DelayingQueue, ExponentialBackoff, RateLimitingQueue, WorkQueue

__all__ = [
    "ADDED",
    "MODIFIED",
    "DELETED",
    "AlreadyExists",
    "Conflict",
    "FencedWrite",
    "NotFound",
    "Substrate",
    "InMemorySubstrate",
    "match_labels",
    "now_iso",
    "ControllerExpectations",
    "RetryPolicy",
    "call_with_retries",
    "is_transient_error",
    "WorkQueue",
    "DelayingQueue",
    "RateLimitingQueue",
    "ExponentialBackoff",
    "EventRecorder",
    "NullRecorder",
    "RealPodControl",
    "RealServiceControl",
    "FakePodControl",
    "FakeServiceControl",
    "owner_reference",
    "is_controlled_by",
]
