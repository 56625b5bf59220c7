"""The decode-serving plane of the port. Counterpart of
tf_operator_tpu/serve/: the HTTP server (`make_server`, `main`), its
client, and the continuous-batching engine over the paged or dense slot
steps of models/gpt.py. The router, fleet harness, autoscaler, batcher
and export are not ported (ROADMAP queue 1, items 5-6 and 8)."""

from .client import DecodeClient, DecodeError
from .engine import ContinuousBatchingEngine, DecodeCancelled, EngineRequest
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
]
