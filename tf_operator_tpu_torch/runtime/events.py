"""Event recorder: lifecycle breadcrumbs on the substrate.

Reference: record.EventRecorder wiring at jobcontroller.go:160-163;
events are part of the operator's observable contract (asserted by the
E2E suite, py/kubeflow/tf_operator/k8s_util.py:158).

Repeated emissions are aggregated the way k8s's event correlator does:
keyed on (kind, name, namespace, reason), the first occurrence records
one substrate Event and later occurrences mutate its count /
last_timestamp / last_message in place — a crash-looping job costs
O(1) substrate events instead of spamming the store. Every emission
(aggregated or not) still lands in the flight recorder, stamped with
the correlation ID active in the calling context (the job UID when the
controller is mid-reconcile), so the full repetition history survives
in /debug/flightz even when the substrate shows one rolled-up Event.

The port's copy of tf_operator_tpu/runtime/events.py; it imports nothing of that package.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Optional, Tuple

from ..api import k8s
from ..telemetry.flight import FlightRecorder, default_flight
from .substrate import Substrate, now_iso

from ..utils import locks

logger = logging.getLogger("tf_operator_tpu_torch.events")

# distinct (kind, name, namespace, reason) keys tracked before the
# oldest rolls off; bounds memory like the recorder ring does
_AGGREGATION_KEYS = 1024


class EventRecorder:
    def __init__(
        self,
        substrate: Substrate,
        component: str = "tfjob-tpu-operator",
        flight: Optional[FlightRecorder] = None,
    ) -> None:
        self._substrate = substrate
        self.component = component
        self._flight = flight
        self._lock = locks.make_lock("EventRecorder._lock")
        self._agg: "OrderedDict[Tuple[str, str, str, str], k8s.Event]" = (
            OrderedDict()
        )

    def event(
        self,
        obj_kind: str,
        obj_name: str,
        namespace: str,
        event_type: str,
        reason: str,
        message: str,
    ) -> None:
        key = (obj_kind, obj_name, namespace, reason)
        with self._lock:
            existing = self._agg.get(key)
            if existing is None:
                event = k8s.Event(
                    type=event_type,
                    reason=reason,
                    message=message,
                    involved_object_kind=obj_kind,
                    involved_object_name=obj_name,
                    involved_object_namespace=namespace,
                    extra={"count": 1},
                )
                self._agg[key] = event
                while len(self._agg) > _AGGREGATION_KEYS:
                    self._agg.popitem(last=False)
            else:
                # the substrate stores this same object: mutating it
                # here updates the event a reader sees via events_for
                existing.extra["count"] = existing.extra.get("count", 1) + 1
                existing.extra["last_timestamp"] = now_iso()
                if message != existing.message:
                    existing.extra["last_message"] = message
                event = None
        if event is not None:
            self._substrate.record_event(event)
            event.extra.setdefault("first_timestamp", event.timestamp)
        (self._flight or default_flight()).record(
            "event",
            reason=reason,
            type=event_type,
            obj=f"{namespace}/{obj_name}",
            obj_kind=obj_kind,
            message=message,
        )
        logger.info(
            "%s %s %s/%s: %s (%s)",
            event_type, reason, namespace, obj_name, message, obj_kind,
        )


class NullRecorder:
    """Recorder that only logs; for tests that don't assert events.
    Still flight-records: the black box sees every emission even when
    the substrate doesn't."""

    def event(self, obj_kind, obj_name, namespace, event_type, reason, message) -> None:
        default_flight().record(
            "event",
            reason=reason,
            type=event_type,
            obj=f"{namespace}/{obj_name}",
            obj_kind=obj_kind,
            message=message,
        )
        logger.debug("%s %s %s/%s: %s", event_type, reason, namespace, obj_name, message)
