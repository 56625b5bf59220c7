"""Fault records: the port's copy of the part of
tf_operator_tpu/chaos/faults.py that the training observe smoke
(train/observe.py run_train_observe_smoke) and the serve fleet's fault
injection (serve/fleet.py) use. The chaos substrate and its other fault
kinds are not part of this copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..telemetry.flight import FlightRecorder, default_flight
from ..utils import locks

FAULT_LATENCY = "latency"  # added latency (the smoke's slowed input pipeline)
FAULT_POD_DEATH = "pod_death"  # container exits 137 (the fleet's kill)
# a decode connection reset before connect or mid-stream (the fleet's
# FaultyClientFactory)
FAULT_CONN_RESET = "conn_reset"


@dataclasses.dataclass
class FaultRecord:
    seq: int
    op: str       # the operation or injection site that drew the fault
    kind: str     # the fault kind, e.g. FAULT_LATENCY
    detail: str = ""


class FaultLog:
    """Ordered record of every injected fault, for assertions after a run
    and for replay. Each append also lands in the flight recorder (kind
    "chaos", with the seed and injection site), so a timeline tells
    injected faults from organic ones."""

    def __init__(self, flight: Optional[FlightRecorder] = None,
                 seed: Optional[int] = None) -> None:
        self._lock = locks.make_lock("FaultLog._lock")
        self._records: List[FaultRecord] = []
        self._flight = flight
        self.seed = seed

    def append(self, op: str, kind: str, detail: str = "") -> FaultRecord:
        with self._lock:
            record = FaultRecord(len(self._records), op, kind, detail)
            self._records.append(record)
        (self._flight or default_flight()).record(
            "chaos", fault=kind, site=op, detail=detail, seed=self.seed, seq=record.seq,
        )
        return record

    def records(self) -> List[FaultRecord]:
        with self._lock:
            return list(self._records)

    def counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for record in self.records():
            counts[record.kind] = counts.get(record.kind, 0) + 1
        return counts

    def kinds(self) -> set:
        return set(self.counts())

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
