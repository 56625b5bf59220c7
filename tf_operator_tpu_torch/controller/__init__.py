"""Controller-side code the port copies from tf_operator_tpu/controller/:
the injectable clock, the status conditions and the ServeService
controller (reconciler, role groups, drain-based rolling update). The
TFJob reconciler is not part of the port."""

from .clock import Clock, FakeClock
from .serve import ServeReconciler, ServeServiceController
from .status import set_condition

__all__ = ["Clock", "FakeClock", "ServeReconciler", "ServeServiceController", "set_condition"]
