"""The part of the reference's chaos layer (tf_operator_tpu/chaos/) that
the training observe smoke uses: the latency fault kind and the fault
log."""

from .faults import FAULT_LATENCY, FaultLog, FaultRecord

__all__ = ["FAULT_LATENCY", "FaultLog", "FaultRecord"]
