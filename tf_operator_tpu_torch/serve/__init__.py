"""The decode-serving plane of the port. Counterpart of
tf_operator_tpu/serve/: the HTTP server (`make_server`, `main`), its
client, the continuous-batching engine over the paged or dense slot
steps of models/gpt.py (with the KV block-set migration of disaggregated
prefill/decode), the window batcher, the prefix-aware router
(`LeastLoadedRouter`), the serving artifact (serve/export.py), and the
serving fleet: serve/fleet.py's InProcessFleet (a live engine server for
each ServeService replica pod that controller/serve.py reconciles, its
failover soak and smokes), the SLO autoscaler (serve/autoscaler.py) and
the fleet observatory (serve/observatory.py). The package exports what
the reference's does; the fleet's modules are imported by name."""

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
