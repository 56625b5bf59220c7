"""SLO observatory: the router's own debug/metrics HTTP plane.

The serve replicas each expose /metrics and /debug/flightz for
THEMSELVES; nothing fleet-level lives anywhere. This module gives the
router the same treatment the replicas get — a small threaded HTTP
server over the router object:

  /debug/routez            router.stats(): per-replica load/score state
                           plus the recent placement-decision ring
                           (each decision carries its trace id)
  /debug/tracez?trace=<id> ONE merged cross-process timeline for a
                           trace: fan out to every replica's flightz,
                           normalize clocks, decompose per-hop TTFT
                           (telemetry/collector.py)
  /debug/slozz             fleet SLOs: per-replica histograms summed
                           bucket-wise into fleet TTFT/ITL/queue-wait
                           quantiles, fleet queue depth + kv occupancy,
                           per-hop p95s, and the router's own
                           client-visible TTFT/ITL histograms
  /metrics                 the router registry's exposition page
                           (includes the fleet_* gauges, refreshed on
                           every /debug/slozz scrape)

Summing cumulative bucket counts across replicas is exact for
quantile estimation (histogram_quantile interpolates within the
merged buckets) — unlike averaging per-replica quantiles, which is
wrong whenever load is skewed.

Stdlib-only, like serve/server.py.

The port's copy of tf_operator_tpu/serve/observatory.py; it imports nothing of that package.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..telemetry.alerts import AlertManager, fleet_rules, render_alertz
from ..telemetry.collector import ClockCache, collect_trace
from ..telemetry.exposition import bucket_pairs
from ..telemetry.flight import default_flight
from ..telemetry.history import MetricHistory, render_historyz
from ..telemetry.registry import histogram_quantile

__all__ = [
    "fleet_slo",
    "fleet_kv_directory",
    "router_trace",
    "make_observatory",
    "observatory_tick",
]

_SERVE = "tf_operator_tpu_serve_"
# replica histogram families merged fleet-wide (engine.py registers
# them; serve_bench.py asserts against the same names)
_FLEET_FAMILIES = {
    "ttft": _SERVE + "ttft_seconds",
    "itl": _SERVE + "inter_token_seconds",
    "queue_wait": _SERVE + "queue_wait_seconds",
    "prefill_chunk": _SERVE + "prefill_chunk_seconds",
    "spec_verify": _SERVE + "spec_verify_seconds",
}
_Q_DEPTH = _SERVE + "engine_queue_depth"
_KV_IN_USE = _SERVE + "engine_kv_blocks_in_use"
_KV_TOTAL = _SERVE + "engine_kv_blocks_total"
_KV_CACHED_IDLE = _SERVE + "engine_kv_cached_idle_blocks"
# restart epoch for the clock cache: a per-process counter that only
# grows within one process lifetime, so a drop across scrapes means
# the replica restarted (ClockCache.observe_epoch)
_COMPILES = _SERVE + "engine_compiles_total"
# speculative-decoding counters (engines with --speculate off simply
# don't export the families; their replicas contribute 0)
_SPEC_PROPOSED = _SERVE + "spec_tokens_proposed_total"
_SPEC_ACCEPTED = _SERVE + "spec_tokens_accepted_total"
# per-tenant QoS counters (server.py admission); summed fleet-wide and
# ingested as fleet_tenant_* history series so the autoscaler's
# describe() can report live reject rates per tenant
_TENANT_PREFIXES = (
    _SERVE + "tenant_requests_total{",
    _SERVE + "tenant_rejected_total{",
)
_ROUTER = "tf_operator_tpu_router_"
# router-registry families: the hops only the router can time, plus
# the client-visible end-to-end numbers (observed per streamed token,
# across failovers — the ones serve_bench's client-side measurements
# must agree with)
_ROUTER_FAMILIES = {
    "route_decision": _ROUTER + "route_decision_seconds",
    "migration": _ROUTER + "migration_seconds",
    "ttft": _ROUTER + "ttft_seconds",
    "itl": _ROUTER + "itl_seconds",
}


def _flat(text: str) -> Dict[str, float]:
    """Exposition page -> {sample_name_with_labels: value} (the
    DecodeClient.metrics() shape bucket_pairs consumes)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.split()
            out[name] = float(value)
    return out


def _merge(acc: Dict[float, float], pairs: List[Tuple[float, float]]):
    for le, count in pairs:
        acc[le] = acc.get(le, 0.0) + count


def _quantiles(pairs: List[Tuple[float, float]]) -> Dict[str, Optional[float]]:
    return {
        "p50": histogram_quantile(0.50, pairs),
        "p95": histogram_quantile(0.95, pairs),
    }


def _exact_quantiles(samples: List[float]) -> Dict[str, Optional[float]]:
    """Linear-interpolated percentiles over raw samples (the router's
    slo_window reservoirs) — sharp where bucket interpolation
    quantizes to edges."""
    if not samples:
        return {"p50": None, "p95": None}
    ordered = sorted(samples)

    def pick(q: float) -> float:
        rank = q * (len(ordered) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(ordered) - 1)
        return ordered[lo] + (ordered[hi] - ordered[lo]) * (rank - lo)

    return {"p50": pick(0.50), "p95": pick(0.95)}


def fleet_kv_directory(router) -> dict:
    """The fleet prefix directory: digest -> sorted list of replicas
    holding that prefix block, built from the per-replica digests the
    router's probes already scrape (no extra network). Derived
    series:

      duplication_factor  mean replicas holding each resident digest
                          (1.0 = perfectly partitioned; 2.0 = every
                          prefix block derived twice fleet-wide)
      unique_blocks       distinct digests anywhere in the fleet

    A digest held by N replicas represents prefill work done N times;
    the directory is the map a peer-to-peer block fetch would consult
    (ROADMAP item 3), surfaced here first as measurement."""
    directory: Dict[str, List[str]] = {}
    per_replica = router.digests()
    for name, info in sorted(per_replica.items()):
        for digest in info["digest"]:
            directory.setdefault(digest, []).append(name)
    for holders in directory.values():
        holders.sort()
    unique = len(directory)
    held = sum(len(holders) for holders in directory.values())
    dup = held / unique if unique else 0.0
    return {
        "directory": directory,
        "unique_blocks": unique,
        "held_blocks": held,
        "duplication_factor": round(dup, 6),
        "replicas_with_digest": sum(
            1 for info in per_replica.values() if info["digest"]
        ),
        "top_duplicated": sorted(
            (
                {"digest": digest, "replicas": holders}
                for digest, holders in directory.items()
                if len(holders) > 1
            ),
            key=lambda row: (-len(row["replicas"]), row["digest"]),
        )[:10],
    }


def fleet_slo(router, history=None, alerts=None, clock_cache=None) -> dict:
    """Scrape every replica once, sum histogram buckets fleet-wide,
    and return the SLO snapshot. Side effect: refreshes the fleet_*
    gauges on router.registry so a plain Prometheus scrape of the
    observatory's /metrics sees the same numbers.

    With `history`, the fleet-summed cumulative buckets and gauges are
    also pushed into the MetricHistory ring (fleet_ttft_seconds etc. —
    the series fleet_rules() watch). With `alerts`, the AlertManager is
    evaluated against that history after ingestion; a scrape that
    missed any replica marks the sample `partial`, which holds firing
    alerts instead of resolving them on missing data. With
    `clock_cache`, each replica's engine_compiles_total is reported as
    its restart epoch (ClockCache.observe_epoch), so a restarted
    replica's stale clock offset is invalidated by the very scrape
    that noticed the restart."""
    merged: Dict[str, Dict[float, float]] = {
        key: {} for key in _FLEET_FAMILIES
    }
    queue_depth = 0.0
    kv_in_use = 0.0
    kv_total = 0.0
    kv_cached_idle = 0.0
    spec_proposed = 0.0
    spec_accepted = 0.0
    tenant_sums: Dict[str, float] = {}
    unreachable: List[str] = []
    clients = router.clients()
    for name, client in clients.items():
        try:
            flat = client.metrics()
        except Exception:
            unreachable.append(name)
            continue
        if clock_cache is not None:
            clock_cache.observe_epoch(name, flat.get(_COMPILES, 0.0))
        for key, family in _FLEET_FAMILIES.items():
            _merge(merged[key], bucket_pairs(flat, family))
        queue_depth += flat.get(_Q_DEPTH, 0.0)
        kv_in_use += flat.get(_KV_IN_USE, 0.0)
        kv_total += flat.get(_KV_TOTAL, 0.0)
        kv_cached_idle += flat.get(_KV_CACHED_IDLE, 0.0)
        spec_proposed += flat.get(_SPEC_PROPOSED, 0.0)
        spec_accepted += flat.get(_SPEC_ACCEPTED, 0.0)
        for sample, value in flat.items():
            if sample.startswith(_TENANT_PREFIXES):
                # "..._serve_tenant_x_total{tenant=\"t\"}" ->
                # "fleet_tenant_x_total{tenant=\"t\"}"
                short = "fleet_" + sample[len(_SERVE):]
                tenant_sums[short] = tenant_sums.get(short, 0.0) + value

    fleet = {
        key: _quantiles(sorted(acc.items()))
        for key, acc in merged.items()
    }
    kv_occupancy = kv_in_use / kv_total if kv_total else 0.0

    router_flat = _flat(router.registry.render())
    router_slo = {
        key: _quantiles(bucket_pairs(router_flat, family))
        for key, family in _ROUTER_FAMILIES.items()
    }
    # the client-visible end-to-end quantiles come from the exact
    # reservoirs (slo_window) — these are the numbers the +-10%
    # acceptance holds against client-side measurements; bucket
    # interpolation stays for the hop histograms, where no tight
    # agreement is promised
    window = router.slo_window()
    for key in ("ttft", "itl"):
        exact = _exact_quantiles(window[key])
        if exact["p95"] is not None:
            router_slo[key] = exact

    hops_p95 = {
        "route_decision": router_slo["route_decision"]["p95"],
        "migration": router_slo["migration"]["p95"],
        "queue_wait": fleet["queue_wait"]["p95"],
        "prefill_chunk": fleet["prefill_chunk"]["p95"],
    }

    reg = router.registry
    g = reg.gauge(
        "fleet_ttft_seconds",
        "Fleet TTFT quantile (bucket-summed across replicas)",
        labelnames=("quantile",),
    )
    g.labels(quantile="0.5").set(fleet["ttft"]["p50"] or 0.0)
    g.labels(quantile="0.95").set(fleet["ttft"]["p95"] or 0.0)
    g = reg.gauge(
        "fleet_itl_seconds",
        "Fleet inter-token-latency quantile (bucket-summed)",
        labelnames=("quantile",),
    )
    g.labels(quantile="0.5").set(fleet["itl"]["p50"] or 0.0)
    g.labels(quantile="0.95").set(fleet["itl"]["p95"] or 0.0)
    reg.gauge(
        "fleet_queue_depth", "Queued requests summed across replicas",
    ).set(queue_depth)
    reg.gauge(
        "fleet_kv_occupancy", "KV blocks in use / total, fleet-wide",
    ).set(kv_occupancy)
    g = reg.gauge(
        "fleet_hop_p95_seconds", "Per-hop p95 across the fleet",
        labelnames=("hop",),
    )
    for hop, value in hops_p95.items():
        g.labels(hop=hop).set(value or 0.0)
    # the fleet prefix directory (KV observatory): duplication and
    # cached-idle pressure, from digests the probes already scraped
    kv_dir = fleet_kv_directory(router)
    waste_tokens = float(
        getattr(router, "reprefill_waste_tokens", 0)
    )
    router.registry.gauge(
        "fleet_kv_duplication_factor",
        "Mean replicas holding each resident prefix block "
        "(1.0 = partitioned, higher = duplicated prefill work)",
    ).set(kv_dir["duplication_factor"])
    router.registry.gauge(
        "fleet_prefix_unique_blocks",
        "Distinct prefix-block digests resident anywhere in the fleet",
    ).set(float(kv_dir["unique_blocks"]))
    router.registry.gauge(
        "fleet_kv_cached_idle_blocks",
        "Cached prefix blocks no live slot shares, summed across "
        "replicas (reclaimable; peer-fetch candidates)",
    ).set(kv_cached_idle)
    spec_accept_rate = (
        spec_accepted / spec_proposed if spec_proposed else 0.0
    )
    reg.gauge(
        "fleet_spec_tokens_proposed_total",
        "Speculative draft tokens proposed, summed across replicas",
    ).set(spec_proposed)
    reg.gauge(
        "fleet_spec_tokens_accepted_total",
        "Speculative draft tokens accepted, summed across replicas",
    ).set(spec_accepted)
    reg.gauge(
        "fleet_spec_accept_rate",
        "Fleet-wide accepted/proposed ratio of speculative drafts",
    ).set(spec_accept_rate)
    partial = bool(unreachable)
    reg.gauge(
        "fleet_scrape_errors",
        "Replicas that failed the last fleet_slo scrape",
    ).set(float(len(unreachable)))

    if history is not None:
        # cumulative fleet-summed buckets: edge-diffing two scrapes in
        # history.bucket_delta() recovers the per-window distribution,
        # so burn-rate math over fleet_ttft_seconds stays exact
        history.ingest_histogram(
            "fleet_ttft_seconds", sorted(merged["ttft"].items())
        )
        history.ingest_histogram(
            "fleet_itl_seconds", sorted(merged["itl"].items())
        )
        history.ingest_value("fleet_queue_depth", "gauge", queue_depth)
        history.ingest_value("fleet_kv_blocks_in_use", "gauge", kv_in_use)
        history.ingest_value("fleet_kv_blocks_total", "gauge", kv_total)
        # fleet KV observatory series: duplication + cached-idle feed
        # the cached-idle-pressure rule; the waste counter stays
        # cumulative so rate() over it is live waste tokens/s
        history.ingest_value(
            "fleet_kv_duplication_factor", "gauge",
            kv_dir["duplication_factor"],
        )
        history.ingest_value(
            "fleet_prefix_unique_blocks", "gauge",
            float(kv_dir["unique_blocks"]),
        )
        history.ingest_value(
            "fleet_kv_cached_idle_blocks", "gauge", kv_cached_idle
        )
        history.ingest_value(
            "fleet_reprefill_waste_tokens_total", "counter",
            waste_tokens,
        )
        history.ingest_value(
            "fleet_scrape_errors", "gauge", float(len(unreachable))
        )
        # cumulative fleet-summed speculative counters: rate() over
        # the pair is the fleet's live accept rate; the gauge ingests
        # too so burn/trend queries can read it directly
        history.ingest_value(
            "fleet_spec_tokens_proposed_total", "counter", spec_proposed
        )
        history.ingest_value(
            "fleet_spec_tokens_accepted_total", "counter", spec_accepted
        )
        history.ingest_value(
            "fleet_spec_accept_rate", "gauge", spec_accept_rate
        )
        # fleet-summed per-tenant counters stay cumulative: rate()
        # over the series is the live reject/request rate per tenant
        for series, value in sorted(tenant_sums.items()):
            history.ingest_value(series, "counter", value)

    tenants: Dict[str, Dict[str, float]] = {}
    for series, value in tenant_sums.items():
        tenant = series.split('tenant="', 1)[-1].rstrip('"}')
        field = (
            "rejected" if "tenant_rejected_total" in series
            else "requests"
        )
        tenants.setdefault(tenant, {})[field] = value

    report = {
        "fleet": {
            **fleet,
            "queue_depth": queue_depth,
            "kv_occupancy": round(kv_occupancy, 6),
            "replicas_scraped": len(clients) - len(unreachable),
            "unreachable": unreachable,
            "scrape_errors": len(unreachable),
            "partial": partial,
            "tenants": tenants,
            "spec": {
                "proposed": spec_proposed,
                "accepted": spec_accepted,
                "accept_rate": round(spec_accept_rate, 6),
            },
        },
        "kv": {
            "duplication_factor": kv_dir["duplication_factor"],
            "unique_blocks": kv_dir["unique_blocks"],
            "held_blocks": kv_dir["held_blocks"],
            "cached_idle_blocks": kv_cached_idle,
            "cached_idle_fraction": round(
                kv_cached_idle / kv_total if kv_total else 0.0, 6
            ),
            "replicas_with_digest": kv_dir["replicas_with_digest"],
            "top_duplicated": kv_dir["top_duplicated"],
            "reprefill_waste_tokens_total": waste_tokens,
            "reprefill_waste_events": int(
                getattr(router, "reprefill_waste_events", 0)
            ),
            "prefix_affinity": bool(
                getattr(router, "prefix_affinity", True)
            ),
        },
        "router": {
            **router_slo,
            "failovers": router.failovers,
            "migrations": router.migrations,
            "migrate_failures": router.migrate_failures,
        },
        "hops_p95": hops_p95,
    }
    if alerts is not None:
        alerts.evaluate(partial=partial)
        report["alerts"] = {
            "firing": alerts.firing(),
            "partial": partial,
        }
    return report


def router_trace(
    router,
    trace_id: str,
    handshake_samples: int = 3,
    clock_cache: Optional[ClockCache] = None,
) -> dict:
    """collect_trace() anchored at this router: its own flight ring
    supplies the local (exact-clock) records, its replica clients the
    remote fetches. A shared ClockCache keeps per-replica clock
    offsets warm across calls, so repeated tracez queries skip the
    handshake until the TTL lapses or the observed RTT degrades."""
    fl = router._flight if router._flight is not None else default_flight()
    local = [r.to_dict() for r in fl.snapshot()]
    return collect_trace(
        trace_id,
        router.clients(),
        local_records=local,
        local_name="router",
        handshake_samples=handshake_samples,
        clock_cache=clock_cache,
    )


def observatory_tick(
    router, history, alerts, autoscaler=None, clock_cache=None
) -> dict:
    """One observatory cadence step: scrape the fleet into history,
    snapshot any tracked sources, evaluate alert rules, and — when an
    autoscaler is wired — let the alert state actuate. Returns the
    fleet_slo report (with alerts and scaling decisions folded in)."""
    report = fleet_slo(
        router, history=history, alerts=alerts, clock_cache=clock_cache
    )
    history.tick()
    if autoscaler is not None:
        report["scale_decisions"] = autoscaler.tick()
    return report


def make_observatory(
    router,
    host: str = "127.0.0.1",
    port: int = 0,
    history: Optional[MetricHistory] = None,
    alerts: Optional[AlertManager] = None,
    history_capacity: int = 512,
    interval_s: float = 0.0,
    autoscaler=None,
) -> ThreadingHTTPServer:
    """In-process observatory server over `router`; caller owns
    serve_forever/shutdown (same contract as serve/server.py
    make_server). GET-only by design — the observatory observes.

    The server carries a fleet-level MetricHistory + AlertManager
    (fleet_rules) and a ClockCache shared across tracez fetches; when
    interval_s > 0 a daemon ticker drives observatory_tick() so the
    burn-rate windows fill without anyone polling /debug/slozz."""
    if history is None:
        history = MetricHistory(capacity=history_capacity)
    if alerts is None:
        alerts = AlertManager(
            history,
            fleet_rules(),
            registry=router.registry,
            flight=(
                router._flight
                if router._flight is not None
                else default_flight()
            ),
        )
    clock_cache = ClockCache()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 5

        def _reply_json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802
            parsed = urlparse(self.path)
            if parsed.path == "/metrics":
                body = router.registry.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif parsed.path == "/debug/routez":
                self._reply_json(200, router.stats())
            elif parsed.path == "/debug/slozz":
                report = fleet_slo(
                    router, history=history, alerts=alerts,
                    clock_cache=clock_cache,
                )
                if autoscaler is not None:
                    report["autoscaler"] = autoscaler.describe()
                self._reply_json(200, report)
            elif parsed.path == "/debug/historyz":
                raw = render_historyz(history, parsed.query)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
            elif parsed.path == "/debug/alertz":
                raw = render_alertz(alerts, parsed.query)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
            elif parsed.path == "/debug/tracez":
                query = parse_qs(parsed.query)
                trace = (query.get("trace") or [None])[0]
                if not trace:
                    self._reply_json(
                        400, {"error": "missing ?trace=<trace id>"}
                    )
                    return
                self._reply_json(
                    200,
                    router_trace(router, trace, clock_cache=clock_cache),
                )
            else:
                self._reply_json(404, {"error": f"no route {parsed.path}"})

        def log_message(self, *args) -> None:
            pass

    class ObservatoryServer(ThreadingHTTPServer):
        def server_close(self) -> None:
            stop = getattr(self, "_tick_stop", None)
            if stop is not None:
                stop.set()
                thread = getattr(self, "_tick_thread", None)
                if thread is not None:
                    thread.join(timeout=2.0)
            super().server_close()

    server = ObservatoryServer((host, port), Handler)
    server.history = history  # type: ignore[attr-defined]
    server.alerts = alerts  # type: ignore[attr-defined]
    server.autoscaler = autoscaler  # type: ignore[attr-defined]
    server.clock_cache = clock_cache  # type: ignore[attr-defined]
    if interval_s > 0:
        stop = threading.Event()

        def _ticker() -> None:
            while not stop.wait(interval_s):
                try:
                    observatory_tick(
                        router, history, alerts,
                        autoscaler=autoscaler, clock_cache=clock_cache,
                    )
                except Exception:
                    pass

        thread = threading.Thread(
            target=_ticker, name="observatory-tick", daemon=True
        )
        thread.start()
        server._tick_stop = stop  # type: ignore[attr-defined]
        server._tick_thread = thread  # type: ignore[attr-defined]
    return server
