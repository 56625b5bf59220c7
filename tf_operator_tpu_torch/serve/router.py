"""Least-loaded request router over a fleet of decode replicas: the
port's copy of tf_operator_tpu/serve/router.py (host-only; its replicas
are the port's decode servers, serve/server.py).

A controller keeps N engine replicas alive; this router keeps *streams*
alive across their deaths.

Disaggregated prefill/decode: replicas carry a role ("prefill",
"decode" or "" for monolithic, from add_replica or their /kv/digest).
Token streams go to the decode pool; before the first byte, when the
chosen decode replica does not cache the prompt's full-block prefix,
_maybe_migrate asks a prefill replica to prefill it and ship the KV
block set there (POST /prefill with migrate_to). Every failure of that
degrades to the monolithic path: the decode replica prefills for itself.

Placement: each replica is scored by live local inflight count plus
the queue-depth / active-slots / mean-active-slots telemetry the
engines export on /metrics, less a capped discount for each full prompt
block it already caches (its /kv/digest); /readyz (503 during warmup
and drain) gates membership. Lowest score wins.

Failover: greedy decoding is deterministic — the chain after a prompt
is a pure function of the prompt. So when a replica dies mid-stream
(connection reset, 5xx, a terminal {"error": ...} event), the router
re-submits to another ready replica with the already-emitted tokens
APPENDED TO THE PROMPT and max_new reduced by the emitted count. The
new replica treats the emitted prefix as forced prompt tokens and
continues the argmax chain bit-identically; the client sees one
uninterrupted stream. Every failover is flight-recorded under the
request's correlation ID (kind "serve", op "failover") so
/debug/flightz?request=<corr> shows the request's whole journey
across replicas.

PEP 567 footnote: generators run in their *consumer's* context, so
binding `correlate(corr)` inside generate_stream would leak between
yields — every flight record here passes corr= explicitly instead.
The fleet trace context (telemetry/tracecontext.py) follows the same
rule: each routed request mints ONE trace id, records carry it
explicitly, and `trace_scope` is only ever held around non-yielding
blocks (the outbound connect calls), never across a yield.
"""

from __future__ import annotations

import collections
import http.client
import itertools
import time
import urllib.error
from typing import Callable, Dict, List, Optional

from ..telemetry.flight import default_flight
from ..telemetry.tracecontext import (
    TraceContext,
    new_span_id,
    new_trace_id,
    trace_scope,
)
from ..utils import locks
from .client import DecodeClient, DecodeError
from .prefix import block_prefix_hashes

_ROUTE_IDS = itertools.count(1)

# metric sample names scraped from each replica's /metrics
_Q_DEPTH = "tf_operator_tpu_serve_engine_queue_depth"
_ACTIVE = "tf_operator_tpu_serve_engine_active_slots"
_ROW_STEPS = "tf_operator_tpu_serve_engine_row_steps_total"
_STEPS = "tf_operator_tpu_serve_engine_steps_total"
_KV_IN_USE = "tf_operator_tpu_serve_engine_kv_blocks_in_use"
_KV_TOTAL = "tf_operator_tpu_serve_engine_kv_blocks_total"
_MESH_DEVICES = "tf_operator_tpu_serve_engine_mesh_devices"
_PREFIX_HITS = "tf_operator_tpu_serve_engine_prefix_cache_hits_total"
_PREFIX_HIT_TOKENS = "tf_operator_tpu_serve_engine_prefix_hit_tokens_total"
_SPEC_ACCEPT_RATE = "tf_operator_tpu_serve_spec_accept_rate"
_SPEC_PROPOSED = "tf_operator_tpu_serve_spec_tokens_proposed_total"
_SPEC_ACCEPTED = "tf_operator_tpu_serve_spec_tokens_accepted_total"

# prefix-overlap discount: each already-cached full block of the
# request's prompt shaves this much off the load score (capped, so a
# giant shared prefix can't route every stream onto one hot replica)
_OVERLAP_WEIGHT = 2.0
_OVERLAP_CAP = 8

# digest-scrape staleness: a replica whose /kv/digest scrape fails
# keeps its LAST digest (one blip shouldn't zero its overlap), but
# after this many consecutive failures the digest expires to the
# empty set — scoring with a digest the replica may no longer hold
# routes streams at phantom warmth
_DIGEST_STALE_PROBES = 3

# connection-level failures that mean "this replica, this attempt" —
# the stream fails over, the replica gets a probe before reuse
FAILOVER_ERRORS = (
    ConnectionError,
    TimeoutError,
    OSError,
    http.client.HTTPException,  # IncompleteRead: stream cut mid-chunk
    urllib.error.URLError,
)


class NoReadyReplicas(RuntimeError):
    """No ready replica accepted the request within the deadline."""


class Replica:
    """Router-side record of one engine replica endpoint."""

    def __init__(
        self, name: str, url: str, client: DecodeClient, role: str = ""
    ) -> None:
        self.name = name
        self.url = url
        self.client = client
        self.role = role       # "" (monolithic) / "prefill" / "decode"
        self.ready = False
        self.draining = False
        self.inflight = 0      # streams this router has on the replica
        self.queue_depth = 0.0
        self.active_slots = 0.0
        self.mean_active = 0.0
        self.kv_occupancy = 0.0  # paged pool fill fraction, 0..1
        self.mesh_devices = 1.0  # decode mesh size (1 = single-device)
        self.prefix_hits = 0.0        # engine_prefix_cache_hits_total
        self.prefix_hit_tokens = 0.0  # engine_prefix_hit_tokens_total
        # speculative decoding (replicas with --speculate off simply
        # never export the families; these stay 0)
        self.spec_accept_rate = 0.0
        self.spec_proposed = 0.0
        self.spec_accepted = 0.0
        self.block_size = 0    # paged block width, from /kv/digest
        self.digest: set = set()  # rolling prefix digest (hash strings)
        self.digest_failures = 0  # consecutive failed digest scrapes
        self.failures = 0

    def overlap(self, prefix_hashes: Optional[dict]) -> int:
        """Full prompt blocks this replica already caches: the size of
        the intersection between the request's block-aligned prefix
        hashes (keyed by block size — replicas may differ) and the
        replica's published digest."""
        if not prefix_hashes or not self.block_size:
            return 0
        mine = prefix_hashes.get(self.block_size)
        return len(mine & self.digest) if mine else 0

    def score(self, overlap: int = 0) -> tuple:
        """Lower routes sooner. Local inflight is the live signal
        (updated per pick/finish); the scraped gauges add the engine's
        own backlog; KV occupancy (paged engines: blocks in use over
        pool size, scaled to weigh like a few inflight streams) keeps
        a memory-full replica from winning ties on slot count alone —
        its next admit would queue behind the block pool; mean active
        slots breaks remaining ties toward the replica that has
        historically run emptier.

        Mesh capacity: a sharded replica is ONE replica, not N — its
        slot grid and block pool don't multiply — but its N devices
        step every slot faster, so queued work drains sooner. Only the
        COMPUTE-bound terms (inflight, queue depth) divide by the mesh
        size; the structural terms (active slots, KV occupancy) stay
        per-replica because a full slot grid or block pool blocks the
        next admit no matter how many shards serve it.

        Prefix overlap: each full prompt block the replica already
        caches is prefill work nobody repeats — it discounts the load
        term so shared-prefix request families land hot, capped so a
        popular prefix can't drown the load signal entirely."""
        return (
            (2 * self.inflight + self.queue_depth)
            / max(1.0, self.mesh_devices)
            + self.active_slots + 4 * self.kv_occupancy
            - _OVERLAP_WEIGHT * min(overlap, _OVERLAP_CAP),
            self.mean_active,
            self.name,
        )

    def score_components(self, overlap: int = 0) -> dict:
        """Every input to score(), itemized — the /debug routing dump
        (stats()) serves these so a placement can be audited."""
        return {
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "kv_occupancy": round(self.kv_occupancy, 4),
            "mesh_devices": self.mesh_devices,
            "mean_active": round(self.mean_active, 4),
            "prefix_overlap": overlap,
            "overlap_discount": _OVERLAP_WEIGHT * min(overlap, _OVERLAP_CAP),
            "score": round(self.score(overlap)[0], 4),
        }


class LeastLoadedRouter:
    """Routes decode requests across replicas; fails streams over.

    Membership is explicit (add_replica/remove_replica — a fleet
    harness wires it to the replicas' lifecycle); health is probed from each
    replica's /readyz + /metrics with probe(). Thread-safe: many
    streams route concurrently."""

    def __init__(
        self,
        client_factory: Optional[Callable[[str], DecodeClient]] = None,
        flight=None,
        stream_deadline: float = 120.0,
        retry_wait: float = 0.05,
        prefix_affinity: bool = True,
    ) -> None:
        # router-owned clients do NOT retry at the transport layer:
        # the router's failover IS the retry, and it must see failures
        # fast to re-place the stream
        from ..runtime.retry import RetryPolicy

        self._client_factory = client_factory or (
            lambda url: DecodeClient(
                url, timeout=60.0,
                retry_policy=RetryPolicy(max_attempts=1),
            )
        )
        self._flight = flight
        self.stream_deadline = stream_deadline
        self.retry_wait = retry_wait
        # prefix_affinity=False zeroes the overlap discount in
        # placement (pure load balancing). The waste attribution below
        # still sees the true overlaps, so an A/B measures exactly what
        # turning the discount off costs in re-prefilled tokens.
        self.prefix_affinity = bool(prefix_affinity)
        self._lock = locks.make_lock("LeastLoadedRouter._lock")
        self._replicas: Dict[str, Replica] = {}
        self.failovers = 0     # lifetime counter, for tests/metrics
        self.migrations = 0    # prefill->decode block-set handoffs
        self.migrate_failures = 0
        # re-prefill waste attribution: per placed stream, the best
        # prefix overlap anywhere in the fleet minus the overlap on the
        # replica actually chosen, in tokens. This is prefill work
        # SOMEBODY already did that the chosen replica re-derives.
        self.reprefill_waste_tokens = 0
        self.reprefill_waste_events = 0
        # router-side SLO registry: the hops only the router can time
        # live (route decision, migration round-trip, client-visible
        # TTFT/ITL across failovers) land in histograms here
        from ..telemetry import (
            FAST_BUCKETS,
            MetricRegistry,
            TTFT_BUCKETS,
        )

        self.registry = MetricRegistry("tf_operator_tpu_router")
        self._h_route = self.registry.histogram(
            "route_decision_seconds",
            "Request arrival to replica pick (queue + scoring)",
            buckets=FAST_BUCKETS,
        )
        self._h_migrate = self.registry.histogram(
            "migration_seconds",
            "Prefill + KV block-set ship round-trip (disagg fast path)",
            buckets=TTFT_BUCKETS,
        )
        self._h_ttft = self.registry.histogram(
            "ttft_seconds",
            "Request arrival to first streamed token, across failovers",
            buckets=TTFT_BUCKETS,
        )
        self._h_itl = self.registry.histogram(
            "itl_seconds",
            "Gap between consecutive streamed tokens, across failovers",
            buckets=FAST_BUCKETS,
        )
        self._c_waste = self.registry.counter(
            "reprefill_waste_tokens_total",
            "Prompt tokens re-prefilled on the chosen replica that "
            "were already warm on some other replica at route time",
        )
        # exact-sample reservoirs behind the histograms: a bucket-
        # interpolated p95 is only as sharp as its bucket edges (a
        # (0.5, 1.0] bucket quantizes to +-2x), so client-visible
        # quantiles are computed from these windows instead
        self._ttft_window: collections.deque = collections.deque(
            maxlen=4096
        )
        self._itl_window: collections.deque = collections.deque(
            maxlen=4096
        )
        # recent placement decisions (ring buffer), served by stats()
        # as the routing dump: what was asked, who won, and every
        # candidate's itemized score at decision time
        self._decisions: collections.deque = collections.deque(maxlen=64)
        # tenant budget state folded into placement: (replica, tenant)
        # -> monotonic time until which that replica's QoS admission
        # has said "not this tenant" (429 + Retry-After). A blocked
        # pair is skipped while alternatives exist — the next replica
        # may hold budget — and expires on its own
        self._tenant_blocks: Dict[tuple, float] = {}

    # -- membership --------------------------------------------------------

    def add_replica(self, name: str, url: str, role: str = "") -> None:
        # construct the client before taking the lock: the factory is
        # injected and may itself lock
        client = self._client_factory(url)
        with self._lock:
            if name in self._replicas:
                return
            self._replicas[name] = Replica(name, url, client, role=role)
        self.probe(name)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def set_draining(self, name: str, draining: bool) -> None:
        """Exclude/readmit a replica for a rolling weight update. The
        caller flips this BEFORE the replica's own /readyz goes 503, so
        no pick races into the drain window."""
        with self._lock:
            replica = self._replicas.get(name)
            if replica is not None:
                replica.draining = draining

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def clients(self) -> Dict[str, DecodeClient]:
        """name -> client snapshot for fan-out consumers that scrape
        every replica."""
        with self._lock:
            return {name: r.client for name, r in self._replicas.items()}

    def digests(self) -> Dict[str, dict]:
        """Per-replica prefix-digest snapshot: name -> {"role",
        "block_size", "ready", "digest": frozenset of hash strings},
        straight from the probe-scraped state (no network)."""
        with self._lock:
            return {
                r.name: {
                    "role": r.role,
                    "block_size": r.block_size,
                    "ready": r.ready,
                    "digest": frozenset(r.digest),
                }
                for r in self._replicas.values()
            }

    def slo_window(self) -> Dict[str, List[float]]:
        """Exact recent client-visible samples — TTFT and inter-token
        gaps, one float per observation, newest last — for quantile
        math (bounded reservoirs; the
        histograms carry the same observations for Prometheus)."""
        return {
            "ttft": list(self._ttft_window),
            "itl": list(self._itl_window),
        }

    # -- health ------------------------------------------------------------

    def probe(self, name: Optional[str] = None) -> None:
        """Refresh readiness + load telemetry from /readyz + /metrics
        for one replica (or all). Failures mark the replica not-ready;
        the next probe can readmit it."""
        with self._lock:
            targets = [
                r for r in self._replicas.values()
                if name is None or r.name == name
            ]
        for replica in targets:
            try:
                ok = replica.client.ready()
                if ok:
                    flat = replica.client.metrics()
                    replica.queue_depth = flat.get(_Q_DEPTH, 0.0)
                    replica.active_slots = flat.get(_ACTIVE, 0.0)
                    steps = flat.get(_STEPS, 0.0)
                    replica.mean_active = (
                        flat.get(_ROW_STEPS, 0.0) / steps if steps else 0.0
                    )
                    kv_total = flat.get(_KV_TOTAL, 0.0)
                    replica.kv_occupancy = (
                        flat.get(_KV_IN_USE, 0.0) / kv_total
                        if kv_total else 0.0  # dense engines: no gauge
                    )
                    # replicas without the gauge stay at 1
                    replica.mesh_devices = max(
                        1.0, flat.get(_MESH_DEVICES, 1.0)
                    )
                    replica.prefix_hits = flat.get(_PREFIX_HITS, 0.0)
                    replica.prefix_hit_tokens = flat.get(
                        _PREFIX_HIT_TOKENS, 0.0
                    )
                    replica.spec_accept_rate = flat.get(
                        _SPEC_ACCEPT_RATE, 0.0
                    )
                    replica.spec_proposed = flat.get(_SPEC_PROPOSED, 0.0)
                    replica.spec_accepted = flat.get(_SPEC_ACCEPTED, 0.0)
                    # rolling prefix digest (paged engines; dense ones
                    # answer block_size 0 + empty digest, which keeps
                    # their overlap at 0)
                    try:
                        dig = replica.client.kv_digest()
                        replica.block_size = int(
                            dig.get("block_size", 0) or 0
                        )
                        replica.digest = set(dig.get("digest") or [])
                        replica.digest_failures = 0
                        if not replica.role and dig.get("role"):
                            replica.role = str(dig["role"])
                    except Exception:  # noqa: BLE001 — servers
                        # without the route just don't share.
                        # The LAST digest stays scoreable through a
                        # scrape blip, but expires to empty after
                        # _DIGEST_STALE_PROBES consecutive failures:
                        # stale overlap must not keep attracting
                        # shared-prefix streams to cold blocks.
                        replica.digest_failures += 1
                        if replica.digest_failures >= _DIGEST_STALE_PROBES:
                            replica.digest = set()
                replica.ready = ok
            except Exception:  # noqa: BLE001 — an unreachable replica
                # is simply not ready
                replica.ready = False

    # -- routing -----------------------------------------------------------

    def _record(self, corr, op, **fields) -> None:
        # explicit None check: FlightRecorder defines __len__, so an
        # injected empty recorder is falsy and `or` would discard it
        flight = self._flight if self._flight is not None else default_flight()
        flight.record("serve", corr=corr, op=op, **fields)

    def _acquire(
        self,
        tried: set,
        deadline: float,
        corr,
        role: Optional[str] = None,
        prefix_hashes: Optional[dict] = None,
        trace: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Replica:
        """Pick the lowest-scored ready replica, preferring ones this
        request hasn't failed on; blocks (probing) until one exists or
        the deadline passes. Bumps the pick's inflight count.

        role asks for a pool ("prefill"/"decode"); when no ready
        replica carries it the pick gracefully degrades to the whole
        ready set (the monolithic path — every replica serves every
        route). prefix_hashes ({block_size: set-of-hashes}) folds
        prefix overlap into the score so shared-prefix families land
        where their blocks already live. tenant folds QoS budget state
        in: replicas that recently 429'd this tenant are avoided while
        un-blocked alternatives exist (soft preference — when every
        candidate is blocked the lowest score still wins, and the
        caller's all-rejected check decides whether to propagate)."""
        while True:
            with self._lock:
                ready = [
                    r for r in self._replicas.values()
                    if r.ready and not r.draining
                ]
                pool = ready
                if role:
                    in_role = [r for r in ready if r.role == role]
                    if in_role:
                        pool = in_role
                candidates = [r for r in pool if r.name not in tried]
                if not candidates and pool and tried:
                    # every ready replica already failed this request
                    # once — second chances beat giving up (it may
                    # have recovered; the probe below re-vetted it)
                    tried.clear()
                    candidates = pool
                if tenant and candidates:
                    now_m = time.monotonic()
                    unblocked = [
                        r for r in candidates
                        if self._tenant_blocks.get(
                            (r.name, tenant), 0.0
                        ) <= now_m
                    ]
                    if unblocked:
                        candidates = unblocked
                if candidates:
                    # overlap feeds the score only under prefix
                    # affinity; the decision ring records the TRUE
                    # overlap either way so stats() (and the waste
                    # attribution) can audit what the pick ignored
                    overlaps = {
                        r.name: r.overlap(prefix_hashes)
                        for r in candidates
                    }

                    def effective(r: Replica) -> int:
                        return (
                            overlaps[r.name]
                            if self.prefix_affinity else 0
                        )

                    best = min(
                        candidates,
                        key=lambda r: r.score(effective(r)),
                    )
                    self._decisions.append({
                        "corr": corr,
                        # the fleet trace id: joins a placement
                        # decision to the request's flight records
                        "trace": trace,
                        "role_requested": role or "",
                        "pool": "role" if pool is not ready else "all",
                        "prefix_affinity": self.prefix_affinity,
                        "picked": best.name,
                        "candidates": {
                            r.name: dict(
                                r.score_components(effective(r)),
                                prefix_overlap=overlaps[r.name],
                            )
                            for r in candidates
                        },
                    })
                    best.inflight += 1
                    return best
            if time.monotonic() > deadline:
                raise NoReadyReplicas(
                    "no ready replica within the deadline "
                    f"(known: {self.replica_names()})"
                )
            # a kill may have taken the whole ready set: re-probe (a
            # controller may be replacing the replica meanwhile) and wait
            self.probe()
            time.sleep(self.retry_wait)

    def _release(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)

    def _attribute_waste(
        self,
        replica: Replica,
        prefix_hashes: Optional[dict],
        corr,
        trace: Optional[str],
    ) -> None:
        """Re-prefill waste accounting for one placed stream: the best
        prefix overlap anywhere in the ready fleet minus the overlap
        on the chosen replica, in tokens (blocks x the warm peer's
        block size). Charged once per stream at the first pick — the
        route-time decision is what left warm blocks unused. Counter
        increments and the kind="kvwaste" flight record happen OUTSIDE
        the router lock (the flight ring and registry have their own
        locks; no ordering edge wanted)."""
        if not prefix_hashes:
            return
        with self._lock:
            chosen = replica.overlap(prefix_hashes)
            peer_name = ""
            peer_overlap = chosen
            peer_bs = replica.block_size
            for r in self._replicas.values():
                if not r.ready or r.draining or r.name == replica.name:
                    continue
                ov = r.overlap(prefix_hashes)
                if ov > peer_overlap or (
                    ov == peer_overlap and peer_name
                    and r.name < peer_name
                ):
                    peer_name = r.name
                    peer_overlap = ov
                    peer_bs = r.block_size
        waste_blocks = peer_overlap - chosen
        if waste_blocks <= 0 or not peer_name:
            return
        waste_tokens = waste_blocks * peer_bs
        with self._lock:
            self.reprefill_waste_tokens += waste_tokens
            self.reprefill_waste_events += 1
        self._c_waste.inc(float(waste_tokens))
        flight = (
            self._flight if self._flight is not None
            else default_flight()
        )
        flight.record(
            "kvwaste", corr=corr, op="kvwaste", trace=trace,
            replica=replica.name, peer=peer_name,
            blocks=waste_blocks, tokens=waste_tokens,
        )

    # -- disaggregated prefill/decode --------------------------------------

    def _prompt_hashes(self, tokens: List[int]) -> dict:
        """{block_size: hash set} over the fleet's distinct paged block
        sizes — computed once per request, matched against each
        candidate's published digest in _acquire (serve/prefix.py is
        the shared hash vocabulary)."""
        with self._lock:
            sizes = {
                r.block_size for r in self._replicas.values()
                if r.block_size
            }
        return {
            bs: set(block_prefix_hashes(tokens, bs)) for bs in sizes
        }

    def _maybe_migrate(
        self,
        decode_replica: Replica,
        prompt: List[int],
        corr,
        prefix_hashes: dict,
        trace: Optional[TraceContext] = None,
    ) -> None:
        """The disaggregated fast path: when a prefill pool exists and
        the decode target doesn't already cache the prompt's full-block
        prefix, run chunked prefill on a prefill replica and ship the
        KV block set to the decode target, so the decode stream admits
        with its prefix hot (zero prefill chunks stealing decode
        quanta). EVERY failure degrades to the monolithic path — the
        decode replica just prefills for itself — flight-recorded
        (op "migrate-failed"), never raised: greedy chains are a pure
        function of the prompt, so the degraded stream is bit-identical,
        only slower."""
        bs = decode_replica.block_size
        if decode_replica.role != "decode" or not bs or len(prompt) < bs:
            return
        if decode_replica.overlap(prefix_hashes) >= len(prompt) // bs:
            return  # the target already caches the whole prefix
        with self._lock:
            pool = [
                r for r in self._replicas.values()
                if r.ready and not r.draining and r.role == "prefill"
            ]
            if not pool:
                return  # no prefill pool: monolithic path
            pre = min(
                pool, key=lambda r: r.score(r.overlap(prefix_hashes))
            )
            pre.inflight += 1
        tid = trace.trace_id if trace is not None else None
        start = time.monotonic()
        try:
            if trace is not None:
                # bind the trace only around the outbound connect (no
                # yield in scope — the module-docstring rule), so the
                # /prefill hop (and its onward /kv/import ship) joins
                # the request's fleet trace
                with trace_scope(trace_id=trace.trace_id):
                    report = pre.client.prefill(
                        prompt, migrate_to=decode_replica.url
                    )
            else:
                report = pre.client.prefill(
                    prompt, migrate_to=decode_replica.url
                )
        except Exception as err:  # noqa: BLE001 — degradation, not
            # failure: the decode replica prefills for itself
            with self._lock:
                self.migrate_failures += 1
            self._record(
                corr, "migrate-failed", prefill=pre.name,
                decode=decode_replica.name, trace=tid,
                error=f"{type(err).__name__}: {err}"[:200],
            )
            return
        finally:
            self._release(pre)
        if report.get("migrated"):
            self._h_migrate.observe(time.monotonic() - start)
            with self._lock:
                self.migrations += 1
                # optimistic digest update: the next probe would learn
                # this anyway, but sibling requests in a shared-prefix
                # family route hot NOW
                decode_replica.digest |= prefix_hashes.get(bs, set())
            self._record(
                corr, "migrate", prefill=pre.name,
                decode=decode_replica.name, trace=tid,
                blocks=int(report.get("blocks", 0)),
                imported=int(report.get("imported", 0)),
            )
        else:
            with self._lock:
                self.migrate_failures += 1
            self._record(
                corr, "migrate-failed", prefill=pre.name,
                decode=decode_replica.name, trace=tid,
                error=str(report.get("error", "no cached blocks"))[:200],
            )

    def _mark_failed(self, replica: Replica, err: BaseException) -> None:
        with self._lock:
            replica.ready = False
            replica.failures += 1
            self.failovers += 1

    def _note_tenant_reject(
        self, replica: Replica, tenant: str, retry_after: float
    ) -> None:
        """Remember a replica's QoS 429 for this tenant until its
        Retry-After elapses, so placement steers the tenant's next
        streams elsewhere first."""
        until = time.monotonic() + max(0.1, float(retry_after))
        with self._lock:
            self._tenant_blocks[(replica.name, tenant)] = until
            if len(self._tenant_blocks) > 256:
                now_m = time.monotonic()
                self._tenant_blocks = {
                    k: v for k, v in self._tenant_blocks.items()
                    if v > now_m
                }

    def generate_stream(
        self,
        input_ids: List[int],
        max_new_tokens: int = 16,
        corr: Optional[str] = None,
        timeout: Optional[float] = None,
        tenant: Optional[str] = None,
    ):
        """One logical stream across the fleet: yields {"token",
        "index", "replica"} per generated token, then a final
        {"done": True, "tokens": [[full chain]], "prompt_lens": [n],
        "request_id": corr, "trace_id": <fleet trace>,
        "failovers": k}. Greedy-only, like the engine path it rides.
        Mid-stream replica failures are replayed on another replica
        with prompt+emitted (see module docstring); 4xx rejections
        propagate as DecodeError (replaying a request the server
        called invalid cannot help). The exception is a QoS 429 (the
        typed {"rejected": ...} event the client surfaces before the
        first byte): budget is per-replica, so the stream tries the
        other ready replicas first and only propagates DecodeError
        429 — carrying the smallest Retry-After seen as a
        `retry_after` attribute — once every one of them has said no.
        tenant rides out as the X-Tenant header on every hop. Every
        hop — the stream itself, migrations, failover replays —
        carries the request's ONE trace id, which joins the whole
        cross-replica journey in the replicas' flight records."""
        prompt = [int(t) for t in input_ids]
        new = int(max_new_tokens)
        if corr is None:
            corr = f"route-{next(_ROUTE_IDS)}"
        # one fleet-wide trace per routed request; records pass it
        # explicitly (this is a generator — no ambient binding may
        # span a yield), outbound connects bind it in a scope
        trace = TraceContext(new_trace_id(), new_span_id())
        t_start = time.monotonic()
        deadline = time.monotonic() + (timeout or self.stream_deadline)
        emitted: List[int] = []
        failovers = 0
        tried: set = set()
        # replica name -> Retry-After from a QoS 429; once every ready
        # replica is in here the request is fleet-rejected
        rejected_by: Dict[str, float] = {}
        self._record(
            corr, "route", trace=trace.trace_id,
            prompt_tokens=len(prompt), new=new,
        )
        # token streams always target the decode pool (prefill
        # replicas take /prefill work; with no role pools _acquire
        # degrades to the whole ready set — today's monolithic path).
        # Resumed streams (emitted tokens appended) re-acquire with
        # the same preference, keeping failover inside the pool.
        prefix_hashes = self._prompt_hashes(prompt)
        migrate_tried = False
        first_token_at = None
        last_token_at = None
        while len(emitted) < new:
            replica = self._acquire(
                tried, deadline, corr, role="decode",
                prefix_hashes=prefix_hashes, trace=trace.trace_id,
                tenant=tenant,
            )
            if not emitted:
                if not migrate_tried:
                    # the pick that will serve the first byte: the
                    # route_decision hop ends here
                    self._h_route.observe(time.monotonic() - t_start)
                self._record(
                    corr, "pick", trace=trace.trace_id,
                    replica=replica.name, role=replica.role,
                )
            if not emitted and not migrate_tried:
                # re-prefill waste is attributed at the FIRST pick,
                # before the migration below can optimistically update
                # the target's digest — the route-time gap between the
                # warmest peer and the chosen replica is the number
                # being measured
                self._attribute_waste(
                    replica, prefix_hashes, corr, trace.trace_id,
                )
                # one migration attempt per request, before the first
                # byte: prefill happens on the prefill pool, the block
                # set ships to THIS decode target, and the stream below
                # admits with its prefix cached
                migrate_tried = True
                self._maybe_migrate(
                    replica, prompt, corr, prefix_hashes, trace=trace,
                )
            def handle_reject(retry_after: float, message: str):
                """Shared 429 bookkeeping (typed event or raised
                DecodeError): steer the tenant away from the replica,
                and once EVERY ready replica has said no, propagate a
                DecodeError 429 carrying the smallest Retry-After —
                the fleet itself is over budget for this tenant."""
                rejected_by[replica.name] = retry_after
                tried.add(replica.name)
                self._note_tenant_reject(
                    replica, tenant or "default", retry_after
                )
                self._record(
                    corr, "qos-reject", trace=trace.trace_id,
                    replica=replica.name, tenant=tenant or "",
                    retry_after=round(retry_after, 3),
                )
                with self._lock:
                    pool = [
                        r.name for r in self._replicas.values()
                        if r.ready and not r.draining
                    ]
                if pool and all(n in rejected_by for n in pool):
                    err = DecodeError(
                        429, message or "tenant over budget on "
                        "every ready replica",
                    )
                    err.retry_after = min(rejected_by.values())
                    self._record(
                        corr, "route-rejected", trace=trace.trace_id,
                        tenant=tenant or "",
                        retry_after=round(err.retry_after, 3),
                    )
                    raise err

            rejected = None
            try:
                # bind the trace around the CONNECT only (the client's
                # generate_stream builds + sends the request eagerly
                # and returns an iterator): the traceparent header
                # rides out, and no yield happens inside the scope
                with trace_scope(trace_id=trace.trace_id):
                    inner = replica.client.generate_stream(
                        prompt + emitted, new - len(emitted),
                        tenant=tenant,
                    )
                for event in inner:
                    if event.get("rejected"):
                        # QoS early-reject — always pre-first-byte
                        # (the client's contract), so nothing was
                        # emitted and another replica can serve whole
                        rejected = event
                        break
                    if "token" in event:
                        now = time.monotonic()
                        if first_token_at is None:
                            first_token_at = now
                            self._h_ttft.observe(now - t_start)
                            self._ttft_window.append(now - t_start)
                        elif last_token_at is not None:
                            self._h_itl.observe(now - last_token_at)
                            self._itl_window.append(now - last_token_at)
                        last_token_at = now
                        emitted.append(int(event["token"]))
                        yield {
                            "token": int(event["token"]),
                            "index": len(prompt) + len(emitted) - 1,
                            "replica": replica.name,
                        }
                    if event.get("done"):
                        break
            except DecodeError as err:
                if err.status == 429:
                    # QoS reject raised instead of surfaced as a typed
                    # event (an injected/legacy client): same budget
                    # bookkeeping, then try the rest of the fleet
                    self._release(replica)
                    handle_reject(
                        float(getattr(err, "retry_after", 0) or 1.0),
                        str(err),
                    )
                    continue
                if err.status < 500 and err.status != 200:
                    # the server judged the request itself bad; a
                    # different replica will say the same thing
                    self._release(replica)
                    raise
                # 5xx or a mid-stream {"error": ...} terminal event
                # (status 200): replica-side failure — fail over
                self._mark_failed(replica, err)
                self._release(replica)
                tried.add(replica.name)
                failovers += 1
                self._record(
                    corr, "failover", trace=trace.trace_id,
                    replica=replica.name,
                    error=f"{type(err).__name__}: {err}"[:200],
                    emitted=len(emitted),
                )
                continue
            except FAILOVER_ERRORS as err:
                self._mark_failed(replica, err)
                self._release(replica)
                tried.add(replica.name)
                failovers += 1
                self._record(
                    corr, "failover", trace=trace.trace_id,
                    replica=replica.name,
                    error=f"{type(err).__name__}: {err}"[:200],
                    emitted=len(emitted),
                )
                continue
            except BaseException:
                # consumer closed us (GeneratorExit) or something
                # unclassified: don't leak the inflight count
                self._release(replica)
                raise
            else:
                self._release(replica)
                if rejected is not None:
                    handle_reject(
                        float(rejected.get("retry_after") or 1.0),
                        str(rejected.get("error") or ""),
                    )
                    continue
                if len(emitted) < new:
                    # clean end-of-stream before the token budget was
                    # met (e.g. the replica began draining and closed
                    # politely): treat like a failover, resume elsewhere
                    tried.add(replica.name)
                    failovers += 1
                    self._record(
                        corr, "failover", trace=trace.trace_id,
                        replica=replica.name,
                        error="short-stream", emitted=len(emitted),
                    )
        self._record(
            corr, "route-done", trace=trace.trace_id,
            tokens=len(emitted), failovers=failovers,
        )
        yield {
            "done": True,
            "tokens": [prompt + emitted],
            "prompt_lens": [len(prompt)],
            "request_id": corr,
            "trace_id": trace.trace_id,
            "failovers": failovers,
        }

    def generate(
        self,
        input_ids: List[List[int]],
        max_new_tokens: int = 16,
        corr: Optional[str] = None,
        timeout: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> List[List[int]]:
        """Non-streaming fan-out: each row rides its own
        generate_stream (so every row gets mid-request failover), and
        the full chains come back together."""
        chains: List[List[int]] = []
        for row in input_ids:
            final: Optional[dict] = None
            for event in self.generate_stream(
                row, max_new_tokens, corr=corr, timeout=timeout,
                tenant=tenant,
            ):
                if event.get("done"):
                    final = event
            assert final is not None  # generate_stream always ends done
            chains.append(final["tokens"][0])
        return chains

    def stats(self) -> dict:
        """Telemetry snapshot for tests and debugging — THE routing
        dump: per-replica state with every score component itemized
        (score_components), the prefix-cache counters scraped from
        each engine, and the recent placement-decision ring."""
        with self._lock:
            now_m = time.monotonic()
            return {
                "failovers": self.failovers,
                "migrations": self.migrations,
                "migrate_failures": self.migrate_failures,
                "prefix_affinity": self.prefix_affinity,
                "reprefill_waste_tokens": self.reprefill_waste_tokens,
                "reprefill_waste_events": self.reprefill_waste_events,
                "tenant_blocks": {
                    f"{name}/{tenant}": round(until - now_m, 3)
                    for (name, tenant), until
                    in self._tenant_blocks.items()
                    if until > now_m
                },
                "replicas": {
                    r.name: {
                        "ready": r.ready,
                        "draining": r.draining,
                        "role": r.role,
                        "inflight": r.inflight,
                        "queue_depth": r.queue_depth,
                        "active_slots": r.active_slots,
                        "kv_occupancy": r.kv_occupancy,
                        "mesh_devices": r.mesh_devices,
                        "prefix_hits": r.prefix_hits,
                        "prefix_hit_tokens": r.prefix_hit_tokens,
                        "spec_accept_rate": r.spec_accept_rate,
                        "spec_proposed": r.spec_proposed,
                        "spec_accepted": r.spec_accepted,
                        "block_size": r.block_size,
                        "digest_size": len(r.digest),
                        "digest_failures": r.digest_failures,
                        "failures": r.failures,
                        "score_components": r.score_components(),
                    }
                    for r in self._replicas.values()
                },
                "decisions": list(self._decisions),
            }
