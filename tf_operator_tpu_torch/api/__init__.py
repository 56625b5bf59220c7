"""The operator's API vocabulary, the port's copy of tf_operator_tpu/api/:
the Kubernetes object subset (`k8s`), the serde, the TFJob and ServeService
types (whose env names the worker bootstrap, parallel/distributed.py,
reads), their validation and defaulting. The serve pod's default command
runs `python -m tf_operator_tpu_torch.serve`."""

from . import k8s, serde, types
from .defaults import set_defaults, set_serve_defaults
from .validation import (
    ValidationError,
    is_valid,
    is_valid_serve_service,
    validate,
    validate_serve_service,
)

__all__ = [
    "k8s",
    "serde",
    "types",
    "set_defaults",
    "set_serve_defaults",
    "validate",
    "validate_serve_service",
    "is_valid",
    "is_valid_serve_service",
    "ValidationError",
]
