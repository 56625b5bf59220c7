"""The decode-serving plane of the port. Counterpart of
tf_operator_tpu/serve/: the HTTP server (`make_server`, `main`), its
client, the continuous-batching engine over the paged or dense slot
steps of models/gpt.py (with the KV block-set migration of disaggregated
prefill/decode), the window batcher, the prefix-aware router
(`LeastLoadedRouter`) and the serving artifact (serve/export.py). The
fleet harness and the autoscaler are not ported (ROADMAP queue 1)."""

from .client import DecodeClient, DecodeError
from .engine import ContinuousBatchingEngine, DecodeCancelled, EngineRequest
from .router import LeastLoadedRouter, NoReadyReplicas
from .server import DecodeHandlerFactory, DecodeHTTPServer, main, make_server

__all__ = [
    "make_server",
    "main",
    "DecodeHandlerFactory",
    "DecodeHTTPServer",
    "DecodeClient",
    "DecodeError",
    "ContinuousBatchingEngine",
    "EngineRequest",
    "DecodeCancelled",
    "LeastLoadedRouter",
    "NoReadyReplicas",
]
