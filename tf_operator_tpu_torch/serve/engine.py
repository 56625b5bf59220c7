"""Continuous batching: a persistent per-step decode loop over a slot
grid (Orca-style iteration-level scheduling). Counterpart of
tf_operator_tpu/serve/engine.py.

The engine's quantum is ONE token: a single-token step runs over a fixed
`[n_slots]` row grid (models/gpt.py SlotDecodeStep or
PagedSlotDecodeStep), and between steps the scheduler admits queued
requests into free slots (prompt ingestion rides the same step through
the ragged forcing rule), evicts finished or cancelled rows at once, and
streams each generated token back to its request as it is produced.

On a CUDA device each program of the step (the decode step, the prefill
chunk and the block copy) is one CUDA graph, captured once at
construction and replayed every quantum, where the reference compiles
each once with jax.jit; `step.compiles == step.prefill_compiles == 1`
is the same contract. The engine thread owns the device: it sets it,
captures the programs and replays them. Other threads only queue
requests and read counters. Everything a captured program reads or
writes keeps its address: the KV pool is zeroed in place after a device
error, new weights are copied into the model's parameters in place, and
a prefix-cache copy-on-write copies between pool blocks in place.

GREEDY requests only (sampled requests keep the server's inline path, so
each owns its generator stream), the gpt family only.

PAGED KV (kv_layout="paged", the default): a fixed pool of fixed-size
blocks addressed through per-slot block tables inside the same step:
- admission reserves exactly ceil((p + new - 1) / block_size) blocks up
  front, so a slot never starves mid-decode; when the pool is short the
  queue head waits FIFO;
- a prefix cache keyed on exact prompt-token chunks shares full prompt
  blocks by refcount; when the whole prompt is cached the tail block is
  copied on the device (copy-on-write) and decode starts at the last
  prompt position;
- chunked prefill: long prompts ingest prefill_chunk tokens a quantum,
  interleaved with decode steps.

kv_layout="dense" keeps the [n_slots, max_total] grid.

kv_quant_int8 / weights_int8 pass through to the step (an int8 pool with
its scales; the model's int8 twin, quantized once here).

SPECULATIVE decoding (speculate="ngram" | "draft", paged only): each
quantum proposes up to a slot's adaptive depth of tokens per slot (a
prompt lookup over the committed chain, numpy on the host, or a small
draft model's captured SlotDecodeStep), scores every slot's window of
spec_depth + 1 in the step's captured verify program, commits the longest
accepted prefix plus the verify's own next token, and rolls the rest back
by resetting the slot's cursor. Greedy acceptance keeps every chain the
single-token engine's wherever the verify's rows compute what the
one-token step computes (exact at f32).

DISAGGREGATED prefill/decode (role="prefill" | "decode", paged only):
`export_prefix_blocks` serializes a prompt's cached full-block prefix
into the reference's JSON block set (base64 leaves in the reference's
tree_flatten order, so a payload crosses between the two packages), and
`import_prefix_blocks` writes one into this pool in place (one
index_copy_ a leaf into the tensors the captured programs read) and
publishes its keys. `prefix_digest` and `kv_statz` are the router's and
the KV observatory's views of the pool.

SHARDED decode (mesh_shape, paged only): the same engine, pool, scheduler
and prefix cache drive models/gpt.py ShardedPagedSlotDecodeStep over a
('batch','model') mesh (parallel/mesh.py make_device_mesh over
`mesh_devices`, by default every device of the engine's type, collapsing
onto fewer as the reference's does): one process drives every shard, so
each program is still one CUDA graph. The gauges engine_mesh_devices,
engine_mesh_model_shards and engine_kv_shard_bytes show the mesh that
formed; a block set is exported and imported with the shards' heads
joined in shard order, the bytes an unsharded engine's pool holds.
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import threading
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops.quant import is_quantized, quantize_model, requantize_into
from ..telemetry.flight import current_correlation, default_flight
from ..telemetry.tracecontext import current_trace
from ..utils import locks
from .prefix import prefix_hash

_DONE = object()

# the adaptive speculation depth: each slot's trailing accept-rate window,
# the collapse and recovery thresholds, and how many quanta a depth-0 slot
# sits out before it probes speculation again
_SPEC_WIN = 8
_SPEC_LOW = 0.3
_SPEC_HIGH = 0.7
_SPEC_PROBE_ROUNDS = 16

# HELP text for the flat metrics() families below, consumed by the
# serve server's /metrics renderer (exposition-format validity needs a
# HELP line per family)
METRIC_HELP = {
    "engine_steps_total": "Decode steps executed by the engine loop",
    "engine_row_steps_total":
        "Slot-rows advanced across all decode steps (steps x occupancy)",
    "engine_admitted_total": "Requests admitted into a slot",
    "engine_finished_total": "Requests that decoded to completion",
    "engine_cancelled_total": "Requests cancelled before or during decode",
    "engine_decode_seconds_total":
        "Wall-clock seconds spent inside decode steps",
    "engine_compiles_total":
        "Captures of the slot decode step as a CUDA graph (first calls "
        "off CUDA; expected: 1)",
    "engine_quanta_total":
        "Scheduler quanta executed (prefill chunks + decode steps + "
        "speculative rounds)",
    "engine_quantum_dispatches_total":
        "Compiled-program dispatches attempted across all quanta "
        "(the --dispatch-guard budget numerator)",
    "engine_active_slots": "Slots currently occupied by a request",
    "engine_queue_depth": "Requests waiting for a free slot",
    "engine_peak_active_slots":
        "High-water mark of concurrently occupied slots",
    "engine_kv_blocks_total": "Usable KV blocks in the paged pool",
    "engine_kv_blocks_in_use":
        "KV blocks held by live slots (excludes idle prefix-cache "
        "blocks)",
    "engine_kv_cached_idle_blocks":
        "Prefix-cache blocks no live slot shares (reclaimable; the "
        "fleet KV observatory sums these into "
        "fleet_kv_cached_idle_blocks)",
    "engine_prefix_cache_blocks":
        "Blocks currently indexed by the prefix cache",
    "engine_prefix_cache_hits_total":
        "Prompt blocks served from the prefix cache",
    "engine_prefix_cache_misses_total":
        "Prompt blocks that missed the prefix cache",
    "engine_prefix_hit_tokens_total":
        "Prompt tokens whose prefill was skipped via the prefix cache",
    "engine_cow_copies_total":
        "Tail blocks copied on admit (prefix-cache copy-on-write)",
    "engine_kv_blocks_reclaimed_total":
        "Idle prefix-cache blocks reclaimed (LRU) to satisfy "
        "allocations",
    "engine_prefill_chunks_total": "Chunked-prefill chunks executed",
    "engine_prefill_seconds_total":
        "Wall-clock seconds spent inside prefill chunks",
    "engine_admit_seconds_total":
        "Wall-clock seconds the scheduler spent admitting requests "
        "into slots (queue drain + block planning + placement)",
    "engine_dispatch_seconds_total":
        "Wall-clock seconds spent dispatching the compiled decode "
        "step (call until the device future returns)",
    "engine_device_sync_seconds_total":
        "Wall-clock seconds blocked materializing step outputs on "
        "the host (device sync)",
    "engine_fanout_seconds_total":
        "Wall-clock seconds spent fanning step outputs out to "
        "request streams (per-slot emit loop)",
    "engine_mesh_devices":
        "Devices in the engine's decode mesh (1 = single-device)",
    "engine_mesh_model_shards":
        "Size of the decode mesh's 'model' axis (tensor-parallel "
        "shards)",
    "engine_kv_pool_bytes": "Total bytes of the paged KV block pool",
    "engine_kv_shard_bytes":
        "Paged KV pool bytes resident per device shard "
        "(= pool bytes / model shards)",
    "engine_kv_blocks_exported_total":
        "KV blocks serialized out of the pool for prefill->decode "
        "migration",
    "engine_kv_blocks_imported_total":
        "KV blocks written into the pool from a migrated block set",
    "engine_migrations_out_total":
        "Block-set exports shipped to another replica",
    "engine_migrations_in_total":
        "Block-set imports admitted from another replica",
    "engine_pool_audit_failures_total":
        "BlockPool.check() audits (drain/stop) that found a refcount "
        "leak or double free",
    "spec_tokens_proposed_total":
        "Draft tokens proposed to the speculative verify step",
    "spec_tokens_accepted_total":
        "Draft tokens the verify step accepted (greedy exact match)",
    "spec_accept_rate":
        "Lifetime accepted/proposed ratio of speculative drafts",
    "spec_rounds_total":
        "Speculative draft+verify rounds executed",
    "spec_fallback_steps_total":
        "Scheduler quanta that fell back to the single-token step "
        "(every live slot's adaptive depth at zero)",
    "spec_verify_seconds_total":
        "Wall-clock seconds spent inside speculative verify rounds",
    "engine_verify_compiles_total":
        "Captures of the speculative verify program as a CUDA graph "
        "(first calls off CUDA; expected: 1)",
    "engine_draft_compiles_total":
        "Captures of the draft model's decode step as a CUDA graph "
        "(first calls off CUDA; expected: 1)",
}


class BlockPool:
    """Refcounted allocator over the paged KV pool + the prefix cache.

    Host-side bookkeeping only (the blocks themselves live in the
    donated device pool); single-writer — only the engine thread
    allocates/releases — with read-only counter access from observer
    threads.

    Block 0 is the SENTINEL: never allocated, permanently referenced.
    Parked rows and unused table tail entries point at it, so the
    compiled step always has a valid scatter/gather target; its
    contents are garbage by design and masked out of every read.

    The prefix cache maps exact prompt-token tuples (one key per FULL
    prompt block: prompt[:block_size], prompt[:2*block_size], ...) to
    block ids. A cached block carries one reference from the cache
    itself plus one per slot sharing it; cache-only blocks (ref == 1)
    are "idle" — still counted available, reclaimed LRU when the free
    list runs dry. Token-tuple keys make collisions impossible and the
    LRU tick is a monotonic counter, not wall time, so eviction order
    is deterministic (the bit-identity soak replays it)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)  # includes the sentinel
        self.total = self.num_blocks - 1   # usable
        self._ref = [0] * self.num_blocks
        self._ref[0] = 1  # sentinel: pinned forever
        self._free = collections.deque(range(1, self.num_blocks))
        self._cached: dict = {}  # token-tuple -> block id
        self._lru: dict = {}     # token-tuple -> last-use tick
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.cow_copies = 0
        self.reclaimed = 0
        # per-block residency metadata (the fleet KV observatory's
        # /kv/statz raw material). All times are pool ticks — the same
        # monotonic counter the LRU uses, never wall clock — so the
        # page is deterministic under the bit-identity soak. A block's
        # metadata is reset when it is re-allocated, so the counts
        # describe the CURRENT residency, not the block id's lifetime.
        self._created = [0] * self.num_blocks      # tick at alloc
        self._last_access = [0] * self.num_blocks  # tick at last touch
        self._attaches = [0] * self.num_blocks     # retains + publish
        self._block_hits = [0] * self.num_blocks   # lookup hits served

    # -- accounting --------------------------------------------------------

    def cached_idle(self) -> int:
        """Cached blocks no live slot shares (ref == 1: cache only)."""
        # list() snapshot: observer threads call this mid-mutation
        return sum(
            1 for b in list(self._cached.values()) if self._ref[b] == 1
        )

    def available(self) -> int:
        """Blocks an allocation burst could obtain right now: the free
        list plus idle cached blocks (reclaimable)."""
        return len(self._free) + self.cached_idle()

    def in_use(self) -> int:
        return self.total - len(self._free) - self.cached_idle()

    # -- refcounts ---------------------------------------------------------

    def retain(self, block: int) -> None:
        self._ref[block] += 1
        self._attaches[block] += 1
        self._last_access[block] = self._tick

    def release(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(f"double free of KV block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            # a cached block always keeps the cache's own reference,
            # so ref 0 means fully private and dead
            self._free.append(block)

    def alloc(self) -> int:
        """One fresh private block (ref 1): free list first, then LRU
        reclaim of an idle cached block. Callers gate admission on
        available(), so exhaustion here is a bug, not backpressure."""
        if self._free:
            block = self._free.popleft()
        else:
            block = self._reclaim()
            if block is None:
                raise RuntimeError(
                    "KV block pool exhausted despite reservation"
                )
        self._ref[block] = 1
        self._tick += 1
        self._created[block] = self._tick
        self._last_access[block] = self._tick
        self._attaches[block] = 1
        self._block_hits[block] = 0
        return block

    def _reclaim(self):
        victim_key = None
        victim_tick = None
        for key, tick in self._lru.items():
            if self._ref[self._cached[key]] != 1:
                continue  # shared with a live slot: not reclaimable
            if victim_tick is None or tick < victim_tick:
                victim_key, victim_tick = key, tick
        if victim_key is None:
            return None
        block = self._cached.pop(victim_key)
        self._lru.pop(victim_key)
        self.reclaimed += 1
        self._ref[block] = 0
        return block

    # -- prefix cache ------------------------------------------------------

    def lookup(self, key):
        """Cached block for one full-prompt-prefix key, bumping its
        LRU tick; None on miss."""
        block = self._cached.get(key)
        if block is not None:
            self._tick += 1
            self._lru[key] = self._tick
            self._block_hits[block] += 1
            self._last_access[block] = self._tick
        return block

    def publish(self, key, block: int) -> None:
        """Index a slot's prompt block under its token key (called at
        the slot's first emit, when all prompt K/V is written). The
        cache takes its own reference; already-cached keys are left
        alone (their existing block stays authoritative)."""
        if key in self._cached:
            return
        self._cached[key] = block
        self._ref[block] += 1
        self._tick += 1
        self._lru[key] = self._tick
        self._attaches[block] += 1
        self._last_access[block] = self._tick

    def cached_blocks(self) -> int:
        return len(self._cached)

    def residency(self, top_n: int = 10) -> dict:
        """The /kv/statz page: per-block residency rolled up into an
        occupancy-by-age histogram, the hot-prefix top-N by hit count,
        the cached-idle vs shared vs private split, and fragmentation
        (blocks that LOOK reclaimable but aren't: cached blocks shared
        with live slots, plus the permanently pinned sentinel).

        Engine-thread only (walks _cached/_ref mid-mutation-free);
        observers go through ContinuousBatchingEngine.kv_statz(),
        which submits here as an engine op. Ages are pool ticks, not
        seconds — deterministic by construction."""
        rev = {block: key for key, block in self._cached.items()}
        split = {"free": len(self._free), "cached_idle": 0,
                 "cached_shared": 0, "private": 0, "sentinel": 1}
        ages: list = []
        hot: list = []
        for block in range(1, self.num_blocks):
            if self._ref[block] <= 0:
                continue
            key = rev.get(block)
            if key is not None:
                if self._ref[block] == 1:
                    split["cached_idle"] += 1
                else:
                    split["cached_shared"] += 1
                hot.append({
                    "digest": prefix_hash(key),
                    "hits": self._block_hits[block],
                    "attaches": self._attaches[block],
                    "age_ticks": self._tick - self._created[block],
                    "idle_ticks":
                        self._tick - self._last_access[block],
                    "idle": self._ref[block] == 1,
                })
            else:
                split["private"] += 1
            ages.append(self._tick - self._created[block])
        # log2 occupancy-by-age buckets over resident blocks: the
        # shape answers "is the cache full of fresh or fossil blocks"
        # without per-block dumps
        edges = [1, 4, 16, 64, 256, 1024, 4096]
        age_hist = [
            {"le": le, "count": sum(1 for a in ages if a <= le)}
            for le in edges
        ]
        age_hist.append({"le": "+Inf", "count": len(ages)})
        hot.sort(
            key=lambda row: (-row["hits"], -row["attaches"],
                             row["digest"])
        )
        unreclaimable = split["cached_shared"] + split["sentinel"]
        return {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "total": self.total,
            "tick": self._tick,
            "split": split,
            "age_histogram": age_hist,
            "hot_prefixes": hot[:max(0, int(top_n))],
            "resident_digests": sorted(
                prefix_hash(key) for key in self._cached
            ),
            "fragmentation": {
                "free": len(self._free),
                "unreclaimable_cached": split["cached_shared"],
                "sentinel": split["sentinel"],
                "ratio": round(unreclaimable / self.num_blocks, 6),
            },
            "counters": {
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "cow_copies": self.cow_copies,
                "reclaimed": self.reclaimed,
            },
        }

    def flush(self) -> None:
        """Drop the whole prefix cache (weights swapped or the device
        pool was rebuilt: cached K/V no longer matches)."""
        for block in list(self._cached.values()):
            self.release(block)
        self._cached.clear()
        self._lru.clear()

    def check(self) -> None:
        """Invariant audit for tests: the sentinel stays pinned, free
        blocks have ref 0 (and vice versa), cached blocks are alive,
        and nothing is double-listed."""
        assert self._ref[0] == 1, "sentinel reference lost"
        free = list(self._free)
        assert len(set(free)) == len(free), "block double-freed"
        for b in free:
            assert self._ref[b] == 0, f"free block {b} has refs"
        assert set(self._cached) == set(self._lru), "LRU out of sync"
        for key, b in self._cached.items():
            assert self._ref[b] >= 1, f"cached block {b} unreferenced"
        free_set = set(free)
        for b in range(1, self.num_blocks):
            if self._ref[b] == 0:
                assert b in free_set, f"block {b} leaked"


class DecodeCancelled(RuntimeError):
    """The request was cancelled before it finished decoding."""


class EngineRequest:
    """Handle for one in-flight request: streams tokens as they are
    produced, or blocks for the full chain. Created by
    ContinuousBatchingEngine.submit(); not constructed directly."""

    __slots__ = (
        "prompt", "new", "tokens", "error", "done", "cancelled",
        "created", "first_token_at", "admitted_at", "last_token_at",
        "span", "corr", "trace", "priority", "wire", "first_slot", "_stream",
    )

    def __init__(self, prompt, new: int, corr=None, trace=None, priority: int = 0,
                 wire: bool = False):
        self.prompt = [int(t) for t in prompt]
        self.new = int(new)
        # QoS class: higher admits ahead of lower while both are staged
        # (FIFO within a class; the staged head is never displaced, see
        # _stage)
        self.priority = int(priority)
        # correlation ID (the server's request id): carried from the
        # HTTP thread into the engine thread, so slot-side flight
        # records join the request's server-side records and span
        self.corr = corr
        # fleet trace id (telemetry/tracecontext.py): captured at
        # submit() from the HTTP thread's bound scope. The scheduler
        # thread runs OUTSIDE any request context, so per-request
        # records there must pass trace=req.trace explicitly — ambient
        # lookup would silently yield nothing (the same PEP 567 edge
        # the router's docstring documents for generators)
        self.trace = trace
        # wire: the consumer relays the tokens over a connection (the
        # server's /generate_stream), so the first-token hop boundary is
        # recorded when the first token is on the wire (on_wire()), not
        # when the engine thread emits it: the hand-off to the consumer
        # thread is part of the time to first token its client measures
        self.wire = bool(wire)
        self.first_slot = None
        self.tokens: list = []  # generated tokens, appended live
        self.error = None
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.created = time.monotonic()
        self.first_token_at = None
        # telemetry (engine-thread-owned): when this request entered a
        # slot, when its previous token left, and its trace span
        self.admitted_at = None
        self.last_token_at = None
        self.span = None
        self._stream: queue.Queue = queue.Queue()

    # -- engine side -------------------------------------------------------

    def _emit(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.append(token)
        self._stream.put(token)

    def _finish(self, error=None) -> None:
        self.error = error
        self.done.set()
        self._stream.put(_DONE if error is None else error)

    # -- client side -------------------------------------------------------

    def on_wire(self) -> None:
        """The first token of a wire request has left on its connection:
        record the first-token hop boundary (telemetry/collector.py)."""
        default_flight().record(
            "serve", corr=self.corr, trace=self.trace,
            op="first-token", slot=self.first_slot,
            ttft=round(time.monotonic() - self.created, 6),
        )

    def cancel(self) -> None:
        """Stop decoding for this request; the engine frees its slot
        before the next step. result()/stream() then raise
        DecodeCancelled."""
        self.cancelled.set()

    def result(self, timeout: float = 600.0):
        """Block until done; -> the full chain (prompt + generated)."""
        if not self.done.wait(timeout):
            self.cancel()
            raise TimeoutError("decode timed out in the engine")
        if self.error is not None:
            raise self.error
        return self.prompt + self.tokens

    def stream(self, timeout: float = 600.0):
        """Yield generated tokens as the engine produces them; raises
        the decode error (or DecodeCancelled) in the consumer."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    @property
    def ttft(self):
        """Seconds from submit to the first generated token, or None
        before it arrives."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.created



def _parse_mesh_shape(mesh_shape):
    """('batch','model') mesh shape from a (rows, cols) tuple or an 'RxC'
    string ('1x2', '2x2': the --mesh-shape flag's wire form)."""
    if isinstance(mesh_shape, str):
        try:
            parts = tuple(int(dim) for dim in mesh_shape.lower().split("x"))
        except ValueError:
            parts = ()
    else:
        parts = tuple(int(dim) for dim in mesh_shape)
    if len(parts) != 2 or any(dim < 1 for dim in parts):
        raise ValueError(
            f"mesh_shape must be 'BATCHxMODEL' or (batch, model) with axes >= 1, "
            f"got {mesh_shape!r}")
    return parts


# a KV block set's leaf dtypes: the payload's dtype string (numpy's name,
# ml_dtypes' "bfloat16" in the reference) -> (the numpy dtype its bytes
# are carried as, the pool's torch dtype). bf16 has no numpy dtype here,
# so its raw bytes travel through an int16 view.
_LEAF_DTYPES = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (np.int16, torch.bfloat16),
    "int8": (np.int8, torch.int8),
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rpartition(".")[2]


def cache_leaves(cache) -> list:
    """The pool's tensors in the reference's tree_flatten order of its
    paged cache ({"layer_<i>": {"attention": {"k", "k_scale", "v",
    "v_scale"}}}): layers in string order of their names (layer_0,
    layer_1, layer_10, layer_11, layer_2, ...), and within a layer k,
    its scale, v, its scale (the scales under int8 KV only)."""
    layers = cache.layers()
    out = []
    for i in sorted(range(len(layers)), key=lambda i: f"layer_{i}"):
        k, v, k_scale, v_scale = layers[i]
        out.extend([k, k_scale, v, v_scale] if cache.quantized else [k, v])
    return out


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode engine over one model, the
    port's GPT module (models/gpt.py), whose parameters the steps read in
    place (no second copy of the weights; under weights_int8 the steps
    read the int8 twin, which replaces the model here).

    One background thread owns the device loop and ALL slot state;
    submit()/cancel() only touch the queue and per-request flags, so there
    is no lock on the hot path. Under kv_layout="paged" (the default) the
    KV lives in a fixed pool of fixed-size blocks mapped through per-slot
    block tables; under "dense" it is the [n_slots, max_total, ...] grid.
    Either way it is one fixed allocation per layer.

    Paged knobs: block_size (tokens per block; max_total must divide
    evenly), kv_blocks (usable pool blocks; 0 sizes the pool to the dense
    equivalent, n_slots * max_total / block_size), prefill_chunk
    (chunked-prefill width; 0 disables chunking), prefix_cache.

    device: where the engine runs (`cuda` unless named; raises without a
    card); the model is moved there. mesh_shape ((batch, model) or
    "BxM", paged only): the sharded step over a mesh of `mesh_devices`
    (default: every device of `device`'s type; a device may repeat),
    whose first device the engine then runs on. The programs are captured at
    construction: on the engine thread with start=True (the constructor
    waits for it), in the caller's thread with start=False, where tests
    drive _admit / _evict_cancelled / _work_once by hand.

    speculate ("off", "ngram", "draft"), spec_depth (the verify window
    minus one, and each slot's depth cap), spec_ngram (the host lookup's
    n) and draft_model (a small GPT sharing the target's vocabulary, for
    "draft") as the reference's, which validates them the same way."""

    def __init__(
        self,
        model,
        n_slots: int = 8,
        max_total: int = 0,
        kv_quant_int8: bool = False,
        weights_int8: bool = False,
        start: bool = True,
        registry=None,
        tracer=None,
        kv_layout: str = "paged",
        block_size: int = 64,
        kv_blocks: int = 0,
        prefill_chunk: int = 64,
        prefix_cache: bool = True,
        mesh_shape=None,
        role: str = "",
        speculate: str = "off",
        spec_depth: int = 4,
        draft_model=None,
        spec_ngram: int = 3,
        device=None,
        mesh_devices=None,
    ):
        from ..models import gpt as gpt_lib

        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}")
        if speculate not in ("off", "ngram", "draft"):
            raise ValueError(f"speculate must be 'off', 'ngram' or 'draft', got {speculate!r}")
        self.speculate = speculate
        self._spec = speculate != "off"
        if self._spec:
            if kv_layout != "paged":
                raise ValueError(
                    "speculative decoding requires kv_layout='paged' (the verify program "
                    "scores windows against the block pool)"
                )
            if int(spec_depth) < 1:
                raise ValueError(f"spec_depth must be >= 1, got {spec_depth}")
            if speculate == "draft":
                if draft_model is None:
                    raise ValueError(
                        "speculate='draft' needs draft_model (a small model sharing the "
                        "tokenizer)"
                    )
                if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                    raise ValueError(
                        f"draft vocab {draft_model.cfg.vocab_size} != target vocab "
                        f"{model.cfg.vocab_size} (the draft must share the tokenizer)"
                    )
        self.spec_depth = int(spec_depth) if self._spec else 0
        self.spec_ngram = int(spec_ngram)
        if mesh_shape is not None and kv_layout != "paged":
            raise ValueError(
                "mesh_shape requires kv_layout='paged' (only the paged step compiles a "
                "sharded variant)")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the engine thread sets the device itself: name it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = None
        if mesh_shape is not None:
            from ..parallel import mesh as mesh_lib

            self.mesh = mesh_lib.make_device_mesh(
                _parse_mesh_shape(mesh_shape), devices=mesh_devices, device=self.device)
            self.device = self.mesh.devices[0][0]
        model.to(self.device)
        if weights_int8:
            # quantize once: the steps read the twin, not the f32 model
            model = quantize_model(model)
        cfg = model.cfg
        max_total = int(max_total) or cfg.max_seq_len
        self.model = model
        self.weights_int8 = bool(weights_int8)
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_total = max_total
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        s = self.n_slots
        if self._paged:
            block_size = int(block_size)
            if block_size < 1 or max_total % block_size:
                raise ValueError(
                    f"block_size {block_size} must be >= 1 and divide max_total {max_total}"
                )
            self.max_blocks = max_total // block_size
            usable = int(kv_blocks) or s * self.max_blocks
            if usable < 1:
                raise ValueError(f"kv_blocks must be >= 1, got {usable}")
            if self.mesh is not None:
                self.step = gpt_lib.ShardedPagedSlotDecodeStep(
                    model, s, max_total, block_size, usable + 1, self.mesh,
                    kv_quant_int8=kv_quant_int8, weights_int8=weights_int8,
                    spec_depth=self.spec_depth,
                )
            else:
                self.step = gpt_lib.PagedSlotDecodeStep(
                    model, s, max_total, block_size, usable + 1,
                    kv_quant_int8=kv_quant_int8, weights_int8=weights_int8,
                    spec_depth=self.spec_depth,
                )
            self.pool = BlockPool(usable + 1, block_size)
            self.prefill_chunk = int(prefill_chunk)
            self._prefix_cache = bool(prefix_cache)
            self._tables = np.zeros((s, self.max_blocks), np.int32)
            # per-slot block bookkeeping (engine-thread-owned): blocks
            # held (table order), keys to publish at first emit, and the
            # full numpy table row
            self._slot_blocks: list = [[] for _ in range(s)]
            self._slot_keys: list = [[] for _ in range(s)]
            self._slot_table = [np.zeros((self.max_blocks,), np.int32) for _ in range(s)]
        else:
            self.step = gpt_lib.SlotDecodeStep(
                model, s, max_total, kv_quant_int8=kv_quant_int8, weights_int8=weights_int8,
            )
            self.pool = None
            self.prefill_chunk = 0
            self._prefix_cache = False
        # the draft model (speculate="draft") is a second captured
        # single-token program over the same slot grid; "ngram" drafts on
        # the host from each slot's committed chain (_spec_buf), so its
        # round costs one device dispatch
        self.draft = None
        if self.speculate == "draft":
            if draft_model.cfg.max_seq_len < max_total:
                raise ValueError(
                    f"draft max_seq_len {draft_model.cfg.max_seq_len} < engine max_total "
                    f"{max_total} (the draft must cover every position it proposes at)"
                )
            draft_model.to(self.device)
            # on a mesh the draft's step is replicated (the reference's)
            self.draft = gpt_lib.SlotDecodeStep(draft_model, s, max_total, mesh=self.mesh)
            self._d_tok = np.zeros((s,), np.int32)
            self._d_index = np.zeros((s,), np.int32)
        if self._spec:
            # the committed chain (prompt + accepted tokens), the ngram
            # drafter's corpus (+1: the last emitted token lands at
            # lens + new - 1, which can equal max_total)
            self._spec_buf = np.zeros((s, max_total + 1), np.int32)
            # per-slot adaptive depth: shrinks when the trailing accept
            # rate collapses, grows back toward spec_depth when it recovers
            self._slot_depth = np.full((s,), self.spec_depth, np.int32)
            self._accept_hist = [collections.deque(maxlen=_SPEC_WIN) for _ in range(s)]
            self._depth_idle = np.zeros((s,), np.int32)
        # slot -> {"offset", "decode_start"} while chunk-prefilling;
        # always present (empty under dense) so the loop can test it
        self._prefilling: dict = {}
        self._cache = self.step.init_cache()
        self._tok = np.zeros((s,), np.int32)
        self._index = np.zeros((s,), np.int32)
        self._lens = np.ones((s,), np.int32)  # idle rows: 1-token dummy
        self._prompt = np.zeros((s, max_total), np.int32)
        self._reqs: list = [None] * s
        self._free = list(range(s))
        self._queue: queue.Queue = queue.Queue()
        # scheduler-owned FIFO the queue drains into: under paged the
        # head may be waiting for blocks, and it must not be overtaken
        self._pending: collections.deque = collections.deque()
        self._stop = threading.Event()
        # engine-thread op queue: pool/cache work requested from other
        # threads (audits) runs between scheduler quanta
        self._ops: collections.deque = collections.deque()
        # serializes submit's stopped-check+enqueue against stop's drain
        self._lifecycle = locks.make_lock("ContinuousBatchingEngine._lifecycle")
        # admission gate (rolling weight updates): cleared by
        # pause_admission(); _drained is set BY THE ENGINE THREAD once it
        # sees the cleared gate with zero active slots
        self._admit_gate = threading.Event()
        self._admit_gate.set()
        # serializes pause_admission's clear against _admit's check and
        # placements: once pause_admission returns, no request is placed
        # until resume_admission (the loop's own check of the gate may
        # be stale by the time it calls _admit)
        self._admit_lock = locks.make_lock("ContinuousBatchingEngine._admit_lock")
        self._drained = threading.Event()
        # counters (engine thread writes, observers read)
        self.steps = 0
        self.row_steps = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.decode_seconds = 0.0
        self.peak_active = 0
        self.prefill_chunks = 0
        self.prefill_seconds = 0.0
        self.pool_audit_failures = 0
        self.pool_audit_ok = True
        self.pool_audit_error = ""
        # KV block-set migration (disaggregated prefill/decode)
        self.kv_blocks_exported = 0
        self.kv_blocks_imported = 0
        self.migrations_out = 0
        self.migrations_in = 0
        # speculation (engine-thread-owned): proposed / accepted drive the
        # accept-rate gauge; fallback_steps counts quanta that ran the
        # single-token step because every live slot's depth was zero
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_fallback_steps = 0
        self.spec_verify_seconds = 0.0
        # where each quantum's wall time goes: admission, step dispatch
        # (input copies and the replay's launch), the wait for the next
        # tokens on the host, stream fan-out
        self.admit_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.sync_seconds = 0.0
        self.fanout_seconds = 0.0
        self.quanta = 0
        self.quantum_dispatches = 0
        self._tracer = tracer
        self._h_ttft = self._h_itl = self._h_queue_wait = None
        self._h_batch = self._h_prefill = None
        self._h_verify = self._g_spec_depth = None
        if registry is not None:
            from ..telemetry import FAST_BUCKETS, LATENCY_BUCKETS, SIZE_BUCKETS, TTFT_BUCKETS

            self._h_ttft = registry.histogram(
                "ttft_seconds", "Time from submit to a request's first generated token",
                buckets=TTFT_BUCKETS,
            )
            self._h_itl = registry.histogram(
                "inter_token_seconds", "Gap between a request's consecutive generated tokens",
                buckets=FAST_BUCKETS,
            )
            self._h_queue_wait = registry.histogram(
                "queue_wait_seconds",
                "Time from submit until the engine admits the request into a slot",
                buckets=LATENCY_BUCKETS,
            )
            self._h_batch = registry.histogram(
                "engine_batch_size", "Occupied slots per decode step", buckets=SIZE_BUCKETS,
            )
            if self._paged and self.prefill_chunk > 0:
                self._h_prefill = registry.histogram(
                    "prefill_chunk_seconds", "Wall-clock latency of one chunked-prefill chunk",
                    buckets=TTFT_BUCKETS,
                )
            if self._spec:
                self._h_verify = registry.histogram(
                    "spec_verify_seconds",
                    "Wall-clock latency of one speculative verify round (draft proposals + "
                    "the multi-token verify call)",
                    buckets=FAST_BUCKETS,
                )
                self._g_spec_depth = registry.gauge(
                    "spec_depth", "Current adaptive speculation depth per slot",
                    labelnames=("slot",),
                )
        # THE one capture per program, paid at construction instead of
        # inside the first request's latency, by the thread that replays
        self.thread = None
        if not start:
            self._warm_up()
            return
        self._warm_error = None
        self._warmed = threading.Event()
        # role ("prefill" / "decode") is advisory, as the reference's: it
        # names the engine thread, which the sampling profiler's role
        # table matches first, and nothing else
        self.thread = threading.Thread(
            target=self._run, name="decode-engine" + (f"-{role}" if role else ""), daemon=True,
        )
        self.thread.start()
        self._warmed.wait()
        if self._warm_error is not None:
            self.thread.join(timeout=10)
            raise self._warm_error

    def _warm_up(self) -> None:
        """Capture every program once on its idle inputs. Paged warms the
        prefill chunk and the copy-on-write against the sentinel block,
        whose contents are garbage by contract."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if not self._paged:
            self.step(self._tok, self._index, self._prompt, self._lens)
            return
        self.step(self._tok, self._index, self._prompt, self._lens, self._tables)
        if self.prefill_chunk > 0:
            self.step.prefill(
                np.zeros((1, self.prefill_chunk), np.int32), 0,
                np.zeros((self.max_blocks,), np.int32),
            )
        self.step.copy_block(0, 0)
        if self._spec:
            self.step.verify(np.zeros((self.n_slots, self.spec_depth + 1), np.int32),
                             self._index, self._prompt, self._lens, self._tables)
        if self.draft is not None:
            self.draft(self._d_tok, self._d_index, self._prompt, self._lens)

    # -- client API --------------------------------------------------------

    def submit(self, prompt, new: int, corr=None, priority: int = 0,
               wire: bool = False) -> EngineRequest:
        """Queue one decode stream; -> its handle (stream()/result()).
        prompt: one row of token ids. corr: correlation ID tying the
        slot's flight records to the submitting request (defaults to the
        context's correlate() binding, the server's request id).
        priority: QoS class; a higher one overtakes lower ones while both
        wait in the scheduler stage (never the staged head). wire: the
        caller relays the stream over a connection and calls the
        handle's on_wire() once the first token is sent."""
        if self._stop.is_set() or (self.thread is not None and not self.thread.is_alive()):
            raise RuntimeError("engine is stopped")
        row = [int(t) for t in prompt]
        if not row:
            raise ValueError("prompt must be non-empty")
        if new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {new}")
        if len(row) + new > self.max_total:
            raise ValueError(
                f"prompt {len(row)} + new {new} exceeds the engine's max_total {self.max_total}"
            )
        if self._paged:
            # the request reserves its worst-case blocks at admission;
            # one that can never fit the pool is rejected HERE
            bs = self.pool.block_size
            blocks = (len(row) + new - 1 + bs - 1) // bs
            if blocks > self.pool.total:
                raise ValueError(
                    f"prompt {len(row)} + new {new} needs {blocks} KV blocks; the pool "
                    f"holds {self.pool.total} ({bs}-token blocks)"
                )
        if corr is None:
            corr = current_correlation()
        ctx = current_trace()
        req = EngineRequest(
            row, new, corr=corr, trace=ctx.trace_id if ctx is not None else None,
            priority=priority, wire=wire,
        )
        if self._tracer is not None:
            span_args = {"prompt_tokens": len(row), "max_new_tokens": new}
            if corr is not None:
                span_args["corr"] = corr
            req.span = self._tracer.begin("serve-request", **span_args)
            req.span.annotate("queued")
        default_flight().record("serve", corr=corr, op="submit", prompt_tokens=len(row), new=new)
        with self._lifecycle:
            # stop() drains the queue under the same lock, so a put here
            # either precedes the drain (and gets failed by it) or raises
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            self._queue.put(req)
        return req

    def generate(self, prompt, lens, new: int, timeout: float = 600.0, priority: int = 0):
        """Batcher-compatible fan-out: prompt [rows, width] right-padded
        with per-row lens -> list of full chains (each row's prompt + new
        tokens). Rows are independent engine streams."""
        prompt = np.asarray(prompt, np.int32)
        reqs: list = []
        deadline = time.monotonic() + timeout
        # a row rejected mid-batch cancels the rows already in flight
        try:
            for i in range(prompt.shape[0]):
                reqs.append(self.submit(prompt[i, :int(lens[i])].tolist(), new,
                                        priority=priority))
            return [req.result(max(deadline - time.monotonic(), 1e-3)) for req in reqs]
        except BaseException:
            for req in reqs:
                req.cancel()
            raise

    def pause_admission(self) -> None:
        """Stop placing queued requests into slots; in-flight slots
        decode to completion, queued requests wait for
        resume_admission()."""
        # clear the ack BEFORE the gate: while the gate is set the engine
        # thread never touches _drained. Under _admit_lock, so that an
        # _admit already past its check finishes before this returns.
        with self._admit_lock:
            self._drained.clear()
            self._admit_gate.clear()

    def resume_admission(self) -> None:
        self._admit_gate.set()

    @property
    def draining(self) -> bool:
        return not self._admit_gate.is_set()

    def drain(self, timeout: float = 60.0) -> bool:
        """Pause admission and wait until every in-flight slot has
        finished; -> True when fully drained. Until resume_admission()
        the engine thread then runs no step, so swap_params() is safe."""
        self.pause_admission()
        if self.thread is None or not self.thread.is_alive():
            if self.active_slots == 0:
                self._drained.set()
                self.audit_pool("drain")
            return self.active_slots == 0
        drained = self._drained.wait(timeout)
        default_flight().record(
            "serve", op="drain", ok=drained, active_slots=self.active_slots,
            queued=self.queue_depth,
        )
        if drained:
            self.audit_pool("drain")
        return drained

    def swap_params(self, params) -> None:
        """Replace the model weights (rolling update): `params` is a
        state dict of the same names and shapes (or a module whose state
        dict is). Only legal on a drained engine. The values are copied
        into the model's own tensors in place, so the captured programs
        read them without a recapture; under weights_int8 an f32 state
        (the unquantized model's) is re-quantized into the int8 twin."""
        state = params.state_dict() if isinstance(params, torch.nn.Module) else params
        with self._lifecycle:
            if self._admit_gate.is_set() or not self._drained.is_set():
                raise RuntimeError(
                    "swap_params requires a drained engine (pause_admission + drain first)"
                )
            own = self.model.state_dict()
            if self.weights_int8 and not is_quantized(state):
                requantize_into(self.model, state)
            elif set(state) != set(own):
                raise ValueError(
                    f"state dict names differ: missing {sorted(set(own) - set(state))}, "
                    f"unexpected {sorted(set(state) - set(own))}"
                )
            else:
                with torch.no_grad():
                    for name, tensor in own.items():
                        tensor.copy_(state[name])
            if self._paged:
                # a sharded step lays the new version out on its mesh again
                self.step.relayout()
                # cached prompt K/V was computed under the OLD weights
                self.pool.flush()
        default_flight().record("serve", op="swap-params")

    # -- KV block-set migration (disaggregated prefill/decode) -------------

    def export_prefix_blocks(self, prompt, corr=None):
        """Serialize the prompt's cached full-block prefix K/V into a
        JSON-able block set (the prefill half of a prefill->decode
        migration): {"block_size", "blocks": m, "tokens": the m blocks'
        tokens, "leaves": [{"dtype", "shape" [m, ...], "data": base64},
        ...] in the reference's leaf order (cache_leaves)}. Walks the
        prefix cache's longest unbroken chain from the front, exactly the
        blocks a later _plan for the same prompt would share, and copies
        each block's rows of every pool tensor to the host. Read-only on
        the pool (refcounts untouched, the sentinel never included) and
        run on the engine thread, so nothing reclaims a block mid-copy.
        None when the prompt has no published full-block prefix yet."""
        if not self._paged:
            raise RuntimeError("KV export requires kv_layout='paged'")
        row = [int(t) for t in prompt]
        # the caller's trace, captured here: op() runs on the engine thread
        ctx = current_trace()
        trace = ctx.trace_id if ctx is not None else None

        def op():
            pool = self.pool
            bs = pool.block_size
            blocks: list = []
            for j in range(len(row) // bs):
                block = pool._cached.get(tuple(row[:(j + 1) * bs]))
                if block is None:
                    break
                blocks.append(block)
            if not blocks:
                return None
            idx = torch.tensor(blocks, dtype=torch.long)
            encoded = []
            for shards in self._leaves():
                # a sharded pool's heads joined in shard order
                name = _dtype_name(shards[0][0].dtype)
                rows = torch.cat([copies[0].index_select(0, idx.to(copies[0].device)).cpu()
                                  for copies in shards], dim=2)
                if rows.dtype == torch.bfloat16:
                    rows = rows.view(torch.int16)
                encoded.append({
                    "dtype": name,
                    "shape": list(rows.shape),
                    "data": base64.b64encode(rows.numpy().tobytes()).decode("ascii"),
                })
            self.kv_blocks_exported += len(blocks)
            self.migrations_out += 1
            default_flight().record(
                "serve", corr=corr, trace=trace, op="kv-export", blocks=len(blocks),
                tokens=len(blocks) * bs,
            )
            return {
                "block_size": bs,
                "blocks": len(blocks),
                "tokens": row[:len(blocks) * bs],
                "leaves": encoded,
            }

        return self._submit_op(op)

    def import_prefix_blocks(self, payload, corr=None):
        """Admit a migrated block set into this engine's pool: for each
        block-aligned prefix key, allocate a fresh block, publish it under
        the key and drop the private reference, ending at refcount 1 (idle
        cached), as a prefix this engine prefilled itself; then write the
        payload's rows into every pool tensor in place, one index_copy_ a
        leaf (the captured programs keep reading the same tensors).
        Already-cached keys are kept (their K/V is authoritative); a short
        pool stops the walk early rather than evicting live work. Returns
        the number of leading prefix blocks now cached: the prefill a
        follow-up request for these tokens skips. A payload whose block
        size, leaf count, dtypes or shapes differ from this pool's raises
        ValueError (the reference's texts) and leaves the pool untouched."""
        if not self._paged:
            raise RuntimeError("KV import requires kv_layout='paged'")
        bs = int(payload.get("block_size", 0))
        if bs != self.pool.block_size:
            raise ValueError(f"block_size mismatch: payload {bs}, pool {self.pool.block_size}")
        m = int(payload.get("blocks", 0))
        tokens = [int(t) for t in payload.get("tokens", [])]
        if m < 1 or len(tokens) < m * bs:
            raise ValueError("malformed KV block-set payload")
        ctx = current_trace()
        trace = ctx.trace_id if ctx is not None else None

        def op():
            leaves = self._leaves()
            encoded = payload.get("leaves", [])
            if len(encoded) != len(leaves):
                raise ValueError(
                    f"cache structure mismatch: payload has {len(encoded)} leaves, "
                    f"engine has {len(leaves)}"
                )
            arrays = []
            for shards, enc in zip(leaves, encoded):
                leaf = shards[0][0]
                name = str(enc["dtype"])
                shape = [int(d) for d in enc["shape"]]
                want = [m] + list(leaf.shape[1:])
                want[2] *= len(shards)  # the heads of every shard
                if name != _dtype_name(leaf.dtype) or shape != want:
                    raise ValueError(
                        f"cache leaf mismatch: payload {name}{shape}, engine "
                        f"{_dtype_name(leaf.dtype)}{want}"
                    )
                carrier, dtype = _LEAF_DTYPES[name]
                arr = np.frombuffer(base64.b64decode(enc["data"]), dtype=carrier).reshape(shape)
                arrays.append(torch.from_numpy(arr.copy()).view(dtype))
            pool = self.pool
            cached = 0
            plan = []  # (payload row j, freshly allocated block)
            for j in range(m):
                key = tuple(tokens[:(j + 1) * bs])
                if pool.lookup(key) is not None:
                    cached += 1
                    continue
                if pool.available() < 1:
                    break  # never evict live work for an import
                block = pool.alloc()
                pool.publish(key, block)
                pool.release(block)  # the cache's own ref keeps it idle
                plan.append((j, block))
                cached += 1
            written = len(plan)
            if written:
                # one write per pool tensor, not one per block: the import
                # runs between scheduler quanta, so its launches are
                # inter-token latency on the decode replica
                rows = torch.tensor([j for j, _ in plan], dtype=torch.long)
                idx = torch.tensor([b for _, b in plan], dtype=torch.long)
                self._write_blocks(leaves, idx, [a.index_select(0, rows) for a in arrays])
            self.kv_blocks_imported += written
            self.migrations_in += 1
            default_flight().record(
                "serve", corr=corr, trace=trace, op="kv-import", blocks=m, written=written,
                cached=cached,
            )
            return cached

        return self._submit_op(op)

    def _leaves(self) -> list:
        """The pool's tensors in the reference's leaf order (cache_leaves):
        for each leaf, for each model shard, that leaf in each of the
        shard's pool copies (one shard with one copy unsharded)."""
        per_shard = [[cache_leaves(pool) for pool in copies] for copies in self.step.shard_pools]
        return [[[leaves[j] for leaves in copies] for copies in per_shard]
                for j in range(len(per_shard[0][0]))]

    def _write_blocks(self, leaves, idx, rows) -> None:
        """Write `rows[i]` ([n, ...] on the host, every shard's heads) into
        pool blocks `idx` of leaf i (`_leaves`), in place: each model
        shard's heads into each of its copies."""
        for shards, data in zip(leaves, rows):
            for copies, part in zip(shards, data.chunk(len(shards), dim=2)):
                for leaf in copies:
                    leaf.index_copy_(0, idx.to(leaf.device),
                                     part.to(leaf.device, non_blocking=False))

    def prefix_digest(self, limit: int = 128) -> list:
        """Hashes of the prefix cache's keys, most recently used first
        (capped): the rolling digest the router folds into placement."""
        if not self._paged:
            return []

        def op():
            items = sorted(self.pool._lru.items(), key=lambda kv: kv[1], reverse=True)
            return [prefix_hash(key) for key, _ in items[:int(limit)]]

        return self._submit_op(op)

    def kv_statz(self, top_n: int = 10) -> dict:
        """The pool's residency page (BlockPool.residency) computed on the
        engine thread. Non-paged engines answer {"paged": False}."""
        if not self._paged:
            return {"paged": False}

        def op():
            page = self.pool.residency(top_n=top_n)
            page["paged"] = True
            return page

        return self._submit_op(op)

    def audit_pool(self, where: str = "audit") -> bool:
        """Run BlockPool.check() on the engine thread; a failed audit is
        surfaced as a flight record + counter. True when clean."""
        if not self._paged:
            return True

        def op():
            try:
                self.pool.check()
            except AssertionError as err:
                self.pool_audit_failures += 1
                self.pool_audit_ok = False
                self.pool_audit_error = str(err)
                default_flight().record("serve", op="pool-audit", ok=False, where=where,
                                  error=str(err))
                return False
            self.pool_audit_ok = True
            self.pool_audit_error = ""
            default_flight().record(
                "serve", op="pool-audit", ok=True, where=where,
                in_use=self.pool.in_use(), cached=self.pool.cached_blocks(),
            )
            return True

        return self._submit_op(op)

    def stop(self) -> None:
        self._stop.set()
        if self.thread is not None:
            self.thread.join(timeout=10)
        # run (inline) any op that raced the stop flag
        self._drain_ops()
        stopped = RuntimeError("engine is stopped")
        drained = []
        with self._lifecycle:
            while True:
                try:
                    drained.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            drained.extend(self._pending)
            self._pending.clear()
        for req in drained:  # fail queued requests so waiters don't hang
            req._finish(stopped)
        for slot, req in enumerate(self._reqs):
            if req is not None:
                self._release(slot, error=stopped)
        self.audit_pool("stop")

    # -- observers ---------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize() + len(self._pending)

    def slots(self) -> tuple:
        """Per-slot request handles (None = free): test/debug view."""
        return tuple(self._reqs)

    def metrics(self) -> dict:
        """(name, kind) -> value rows for the server's /metrics."""
        out = {
            ("engine_steps_total", "counter"): self.steps,
            ("engine_row_steps_total", "counter"): self.row_steps,
            ("engine_admitted_total", "counter"): self.admitted,
            ("engine_finished_total", "counter"): self.finished,
            ("engine_cancelled_total", "counter"): self.cancelled,
            ("engine_decode_seconds_total", "counter"): self.decode_seconds,
            ("engine_admit_seconds_total", "counter"): self.admit_seconds,
            ("engine_dispatch_seconds_total", "counter"): self.dispatch_seconds,
            ("engine_device_sync_seconds_total", "counter"): self.sync_seconds,
            ("engine_fanout_seconds_total", "counter"): self.fanout_seconds,
            ("engine_compiles_total", "counter"): self.step.compiles,
            ("engine_quanta_total", "counter"): self.quanta,
            ("engine_quantum_dispatches_total", "counter"): self.quantum_dispatches,
            ("engine_active_slots", "gauge"): self.active_slots,
            ("engine_queue_depth", "gauge"): self.queue_depth,
            ("engine_peak_active_slots", "gauge"): self.peak_active,
            ("engine_mesh_devices", "gauge"): 1 if self.mesh is None else self.mesh.size,
            ("engine_mesh_model_shards", "gauge"): (
                1 if self.mesh is None else self.mesh.shape["model"]),
        }
        if self._spec:
            out.update({
                ("spec_tokens_proposed_total", "counter"): self.spec_proposed,
                ("spec_tokens_accepted_total", "counter"): self.spec_accepted,
                ("spec_accept_rate", "gauge"): (
                    self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0
                ),
                ("spec_rounds_total", "counter"): self.spec_rounds,
                ("spec_fallback_steps_total", "counter"): self.spec_fallback_steps,
                ("spec_verify_seconds_total", "counter"): self.spec_verify_seconds,
                ("engine_verify_compiles_total", "counter"): self.step.verify_compiles,
            })
            if self.draft is not None:
                out[("engine_draft_compiles_total", "counter")] = self.draft.compiles
        if self._paged:
            pool = self.pool
            out.update({
                ("engine_kv_blocks_total", "gauge"): pool.total,
                ("engine_kv_blocks_in_use", "gauge"): pool.in_use(),
                ("engine_kv_cached_idle_blocks", "gauge"): pool.cached_idle(),
                ("engine_prefix_cache_blocks", "gauge"): pool.cached_blocks(),
                ("engine_prefix_cache_hits_total", "counter"): pool.hits,
                ("engine_prefix_cache_misses_total", "counter"): pool.misses,
                ("engine_prefix_hit_tokens_total", "counter"): pool.hit_tokens,
                ("engine_cow_copies_total", "counter"): pool.cow_copies,
                ("engine_kv_blocks_reclaimed_total", "counter"): pool.reclaimed,
                ("engine_prefill_chunks_total", "counter"): self.prefill_chunks,
                ("engine_prefill_seconds_total", "counter"): self.prefill_seconds,
                ("engine_kv_pool_bytes", "gauge"): self.step.kv_bytes_total,
                ("engine_kv_shard_bytes", "gauge"): self.step.kv_bytes_per_shard,
                ("engine_pool_audit_failures_total", "counter"): self.pool_audit_failures,
                ("engine_kv_blocks_exported_total", "counter"): self.kv_blocks_exported,
                ("engine_kv_blocks_imported_total", "counter"): self.kv_blocks_imported,
                ("engine_migrations_out_total", "counter"): self.migrations_out,
                ("engine_migrations_in_total", "counter"): self.migrations_in,
            })
        return out

    # -- engine thread -----------------------------------------------------

    def _run(self) -> None:
        try:
            self._warm_up()
        except BaseException as err:  # noqa: BLE001 — re-raised by __init__
            self._warm_error = err
            self._warmed.set()
            return
        self._warmed.set()
        while not self._stop.is_set():
            self._drain_ops()
            if not self._admit_gate.is_set():
                # draining: finish in-flight slots, admit nothing; the
                # ack is set by this thread after the last slot released
                self._evict_cancelled()
                if self.active_slots:
                    self._work_once()
                else:
                    self._drained.set()
                    self._stop.wait(0.005)
                continue
            self._admit()
            self._evict_cancelled()
            if self.active_slots == 0:
                # idle: park on the queue instead of spinning
                try:
                    self._pending.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue
                self._admit()
                continue
            self._work_once()

    def _drain_ops(self) -> None:
        """Run queued cross-thread ops (engine thread only)."""
        while self._ops:
            fn, box, done = self._ops.popleft()
            try:
                box["result"] = fn()
            except BaseException as err:  # noqa: BLE001 — relayed to caller
                box["error"] = err
            done.set()

    def _submit_op(self, fn, timeout: float = 60.0):
        """Run ``fn`` on the engine thread between scheduler quanta and
        return its result (exceptions re-raise here); inline when no
        scheduler thread runs."""
        if self.thread is None or not self.thread.is_alive():
            return fn()
        box: dict = {}
        done = threading.Event()
        self._ops.append((fn, box, done))
        if not done.wait(timeout):
            raise TimeoutError("engine op timed out")
        if box.get("error") is not None:
            raise box["error"]
        return box.get("result")

    def _stage(self, req: EngineRequest) -> None:
        """Insert a drained request into the scheduler stage. Equal
        priorities stay strictly FIFO; a higher priority overtakes every
        staged lower-priority request EXCEPT the current head: once a
        request reaches the front it keeps it (the paged head may be
        waiting for blocks, and displacing it would let it starve)."""
        if req.priority and self._pending:
            for i in range(len(self._pending) - 1, 0, -1):
                if self._pending[i].priority >= req.priority:
                    self._pending.insert(i + 1, req)
                    return
            self._pending.insert(1, req)
            return
        self._pending.append(req)

    def _admit(self) -> None:
        started = time.monotonic()
        # drain the client queue into the scheduler-owned stage first:
        # arrival order holds within a priority class; classes reorder
        # at the stage hop only
        while True:
            try:
                self._stage(self._queue.get_nowait())
            except queue.Empty:
                break
        with self._admit_lock:
            # the gate as pause_admission leaves it, not as the loop read it
            while self._admit_gate.is_set() and self._pending and self._free:
                req = self._pending[0]
                plan = None
                if not req.cancelled.is_set() and self._paged:
                    plan = self._plan(req)
                    if plan[4] > self.pool.available():
                        # the HEAD waits for blocks (freed as running
                        # slots finish) — strict FIFO, no overtaking, no
                        # mid-stream eviction of anyone else
                        break
                self._pending.popleft()
                self._place(req, plan)
        self.admit_seconds += time.monotonic() - started

    def _plan(self, req: EngineRequest):
        """Prefix-cache match + block budget for one request ->
        (shared cached blocks, CoW source or None, first decode index,
        fresh blocks to allocate, blocks the admission must see
        available). `new` is exact (greedy always runs its full
        budget) and positions 0 .. p+new-2 are the ones written, so
        the reservation guarantees the slot can never run out of
        blocks mid-decode.

        The reserve is larger than the fresh count when shared/CoW
        blocks are currently IDLE in the cache: retaining them removes
        them from the reclaimable set, so admission must budget for
        that shrinkage or the allocs below could exhaust the pool."""
        pool = self.pool
        bs = pool.block_size
        p = len(req.prompt)
        full = p // bs          # whole blocks the prompt fills
        limit = (p - 1) // bs   # shareable without CoW: the block
        #                         holding p-1 is rewritten at decode
        shared: list = []
        cow_src = None
        if self._prefix_cache:
            for j in range(full):
                block = pool.lookup(tuple(req.prompt[:(j + 1) * bs]))
                if block is None:
                    break
                shared.append(block)
        if len(shared) > limit:
            # the WHOLE prompt is cached (p % bs == 0): its last block
            # still needs position p-1's K/V rewritten to launch the
            # argmax chain, so it is copied (CoW), never shared
            cow_src = shared.pop()
        blocks = (p + req.new - 1 + bs - 1) // bs  # ceil over written
        if cow_src is not None and blocks >= pool.total:
            # CoW transiently holds source + copy; at a full-pool
            # reservation that extra block could NEVER become
            # available — degrade to plain sharing (the tail block is
            # recomputed via the forcing rule) instead of deadlocking
            cow_src = None
        m = len(shared)
        start = p - 1 if cow_src is not None else m * bs
        held_idle = sum(
            1 for b in shared + ([cow_src] if cow_src is not None else [])
            if pool._ref[b] == 1
        )
        return shared, cow_src, start, blocks - m, blocks - m + held_idle

    def _place(self, req: EngineRequest, plan=None) -> None:
        if req.cancelled.is_set():
            self.cancelled += 1
            if req.span is not None:
                req.span.finish(outcome="cancelled")
            default_flight().record(
                "serve", corr=req.corr, trace=req.trace, op="evict",
                outcome="cancelled-before-admission",
            )
            req._finish(DecodeCancelled("cancelled before admission"))
            return
        req.admitted_at = time.monotonic()
        if self._h_queue_wait is not None:
            self._h_queue_wait.observe(req.admitted_at - req.created)
        if req.span is not None:
            req.span.annotate("admitted")
        default_flight().record(
            "serve", corr=req.corr, trace=req.trace, op="admit",
            slot=self._free[0],
            queue_wait=round(req.admitted_at - req.created, 6),
        )
        slot = self._free.pop(0)
        self._reqs[slot] = req
        n = len(req.prompt)
        self._prompt[slot, :] = 0
        self._prompt[slot, :n] = req.prompt
        if self._spec:
            # the ngram drafter mines the prompt before anything is generated
            self._spec_buf[slot, :] = 0
            self._spec_buf[slot, :n] = req.prompt
        self.admitted += 1
        self.peak_active = max(self.peak_active, self.active_slots)
        if not self._paged:
            self._lens[slot] = n
            self._index[slot] = 0
            self._tok[slot] = req.prompt[0]
            return
        pool = self.pool
        shared, cow_src, start, need, _ = plan or self._plan(req)
        bs = pool.block_size
        # prefix-cache accounting: one hit per reused prompt block
        # (CoW counts — its prefill is skipped), one miss per prompt
        # block computed from scratch
        reused = len(shared) + (1 if cow_src is not None else 0)
        pool.hits += reused
        pool.misses += n // bs - reused
        pool.hit_tokens += start
        # retain BEFORE any alloc: a retained block has ref >= 2 and
        # can never be LRU-reclaimed out from under this request
        for block in shared:
            pool.retain(block)
        if cow_src is not None:
            pool.retain(cow_src)
        fresh = [pool.alloc() for _ in range(need)]
        if cow_src is not None:
            self.step.copy_block(cow_src, fresh[0])
            pool.release(cow_src)  # the slot keeps only the copy
            pool.cow_copies += 1
        blocks = shared + fresh
        self._slot_blocks[slot] = blocks
        # keys for the slot's FULL prompt blocks, published at first
        # emit (all prompt K/V is in the pool by then)
        self._slot_keys[slot] = [
            (tuple(req.prompt[:(j + 1) * bs]), blocks[j])
            for j in range(n // bs)
        ]
        table = self._slot_table[slot]
        table[:] = 0
        table[:len(blocks)] = blocks
        default_flight().record(
            "serve", corr=req.corr, trace=req.trace, op="kv-plan",
            slot=slot, shared=len(shared), fresh=need,
            cow=cow_src is not None, start=start,
        )
        chunk = self.prefill_chunk
        n_chunks = (n - 1 - start) // chunk if chunk > 0 else 0
        if n_chunks > 0:
            # park the row on the sentinel while its chunks run; it
            # joins the decode grid in _activate
            self._prefilling[slot] = {
                "offset": start,
                "decode_start": start + n_chunks * chunk,
            }
            self._tables[slot, :] = 0
            self._lens[slot] = 1
            self._index[slot] = 0
            self._tok[slot] = 0
        else:
            self._activate(slot, start)

    def _activate(self, slot: int, start: int) -> None:
        """Join the decode grid at index `start`: positions < start
        came from the prefix cache and/or prefill chunks; the rest of
        the prompt rides the forcing rule."""
        req = self._reqs[slot]
        self._tables[slot, :] = self._slot_table[slot]
        self._lens[slot] = len(req.prompt)
        self._index[slot] = start
        self._tok[slot] = req.prompt[start]
        if self._spec:
            # a fresh occupant: full depth, clean history, no probe debt
            self._slot_depth[slot] = self.spec_depth
            self._accept_hist[slot].clear()
            self._depth_idle[slot] = 0
            if self.draft is not None:
                # the draft row joins at the same position; positions a
                # prefix hit or prefill chunk skipped are missing from the
                # draft's cache, which costs acceptance, never correctness
                self._d_tok[slot] = req.prompt[start]
                self._d_index[slot] = start

    def _evict_cancelled(self) -> None:
        for slot, req in enumerate(self._reqs):
            if req is not None and req.cancelled.is_set():
                self.cancelled += 1
                self._release(slot, error=DecodeCancelled("cancelled"))

    def _release(self, slot: int, error=None) -> None:
        req = self._reqs[slot]
        self._reqs[slot] = None
        self._free.append(slot)
        # park the row as an idle 1-token dummy; its stale KV is
        # masked (each row attends <= its own index only) and gets
        # overwritten position-by-position by the next occupant
        self._tok[slot] = 0
        self._index[slot] = 0
        self._lens[slot] = 1
        if self.draft is not None:
            self._d_tok[slot] = 0
            self._d_index[slot] = 0
        if self._paged:
            self._prefilling.pop(slot, None)
            self._tables[slot, :] = 0  # back onto the sentinel
            self._slot_table[slot][:] = 0
            for block in self._slot_blocks[slot]:
                self.pool.release(block)
            self._slot_blocks[slot] = []
            self._slot_keys[slot] = []
        if req is not None:
            if error is None:
                outcome = "finished"
            elif isinstance(error, DecodeCancelled):
                outcome = "cancelled"
            else:
                outcome = "error"
            if req.span is not None:
                if error is None:
                    req.span.annotate("finished")
                    req.span.finish(outcome="finished")
                elif isinstance(error, DecodeCancelled):
                    req.span.finish(outcome="cancelled")
                else:
                    req.span.finish(
                        outcome="error", error=type(error).__name__
                    )
            default_flight().record(
                "serve", corr=req.corr, trace=req.trace, op="evict",
                slot=slot, outcome=outcome, tokens=len(req.tokens),
            )
            req._finish(error)

    def _work_once(self) -> None:
        """One scheduler quantum: at most ONE prefill chunk (so a long
        prompt's ingestion is amortized across quanta), then a decode
        step whenever any non-prefilling slot is live — active streams
        keep emitting while a long prompt chunks in, which is the
        whole point of chunked prefill."""
        if self._prefilling:
            self._prefill_once()
        live = [
            slot for slot, req in enumerate(self._reqs)
            if req is not None and slot not in self._prefilling
        ]
        if not live:
            return
        if not self._spec:
            self._step_once()
            return
        # a slot whose depth collapsed sits out _SPEC_PROBE_ROUNDS quanta
        # on the plain step, then probes speculation again at depth 1
        for slot in live:
            if self._slot_depth[slot] == 0:
                self._depth_idle[slot] += 1
                if self._depth_idle[slot] >= _SPEC_PROBE_ROUNDS:
                    self._slot_depth[slot] = 1
                    self._depth_idle[slot] = 0
                    self._accept_hist[slot].clear()
        if any(self._slot_depth[slot] > 0 for slot in live):
            self._spec_once(live)
        else:
            self.spec_fallback_steps += 1
            self._step_once()

    def _prefill_once(self) -> None:
        slot, state = next(iter(self._prefilling.items()))
        req = self._reqs[slot]
        off = state["offset"]
        chunk = self.prefill_chunk
        tokens = np.asarray(
            [req.prompt[off:off + chunk]], np.int32
        )
        self.quanta += 1
        self.quantum_dispatches += 1
        start = time.monotonic()
        try:
            self.step.prefill(tokens, off, self._slot_table[slot])
        except Exception as err:  # noqa: BLE001 — fan out, stay alive
            self._fail_all(err)
            return
        took = time.monotonic() - start
        self.prefill_chunks += 1
        self.prefill_seconds += took
        if self._h_prefill is not None:
            self._h_prefill.observe(took)
        default_flight().record(
            "serve", corr=req.corr, trace=req.trace, op="prefill-chunk",
            slot=slot, offset=off, tokens=chunk,
        )
        state["offset"] = off + chunk
        self._prefilling.pop(slot)
        if state["offset"] >= state["decode_start"]:
            self._activate(slot, state["decode_start"])
        else:
            # reinsert at the back: concurrent prefills round-robin
            self._prefilling[slot] = state

    def _fail_all(self, err) -> None:
        """The cache's state is unknown after a failed device call: zero
        it IN PLACE (the captured programs keep its addresses), fail
        every in-flight request as JSON-able errors (a dead engine would
        hang all later requests), and drop the prefix cache, whose
        blocks' device contents just went."""
        default_flight().record(
            "serve", op="step-error", error=type(err).__name__,
            slots=self.active_slots,
        )
        self._cache = self.step.init_cache()
        if self.draft is not None:
            self.draft.init_cache()
        for slot, req in enumerate(self._reqs):
            if req is not None:
                self._release(slot, error=err)
        if self._paged:
            self.pool.flush()

    def _step_once(self) -> None:
        self.quanta += 1
        self.quantum_dispatches += 1
        start = time.monotonic()
        try:
            if self._paged:
                nxt = self.step(
                    self._tok, self._index, self._prompt, self._lens,
                    self._tables,
                )
            else:
                nxt = self.step(
                    self._tok, self._index, self._prompt, self._lens,
                )
            dispatched = time.monotonic()
            # the next tokens come back to the host once a step
            nxt = nxt.cpu().numpy()
        except Exception as err:  # noqa: BLE001 — fan out, stay alive
            self._fail_all(err)
            return
        synced = time.monotonic()
        self.decode_seconds += synced - start
        self.dispatch_seconds += dispatched - start
        self.sync_seconds += synced - dispatched
        self.steps += 1
        slots_now = self.active_slots
        self.row_steps += slots_now
        if self._h_batch is not None:
            self._h_batch.observe(slots_now)
        now = time.monotonic()
        for slot, req in enumerate(self._reqs):
            if req is None or slot in self._prefilling:
                # prefilling slots ride the batch as parked rows aimed
                # at the sentinel block — their lane's output is noise
                # until _activate() points the row at real blocks
                continue
            pos = int(self._index[slot]) + 1
            self._tok[slot] = nxt[slot]
            self._index[slot] = pos
            if self._spec:
                # fallback steps feed the chain the ngram drafter mines too
                self._spec_buf[slot, pos] = nxt[slot]
            if pos >= int(self._lens[slot]):
                req._emit(int(nxt[slot]))
                self._post_emit(slot, req, now)
                if pos == int(self._lens[slot]) + req.new - 1:
                    self.finished += 1
                    self._release(slot)
        fanout = time.monotonic() - synced
        self.fanout_seconds += fanout
        # the per-step breadcrumb: the slot grid's occupancy over time
        # IS the engine's narrative (one ring slot per step, no
        # allocation beyond the record tuple — SERVE_BENCH stays flat).
        # Emitted AFTER the fan-out so the record carries the full
        # quantum split: dispatch / device sync / stream fan-out.
        default_flight().record(
            "serve", op="step", step=self.steps, slots=slots_now,
            dispatch=round(dispatched - start, 6),
            sync=round(synced - dispatched, 6),
            fanout=round(fanout, 6),
        )

    def _post_emit(self, slot: int, req, now: float) -> None:
        """Per-emitted-token bookkeeping: first emit observes TTFT and
        publishes the slot's prompt blocks to the prefix cache; later
        emits observe inter-token latency."""
        if req.last_token_at is None:
            if self._h_ttft is not None:
                self._h_ttft.observe(now - req.created)
            if req.span is not None:
                req.span.annotate("first-token")
            # the TTFT endpoint is a hop boundary the trace
            # collector decomposes on (telemetry/collector.py); a wire
            # request records it when its consumer has sent the token
            if req.wire:
                req.first_slot = slot
            else:
                default_flight().record(
                    "serve", corr=req.corr, trace=req.trace,
                    op="first-token", slot=slot,
                    ttft=round(now - req.created, 6),
                )
            if self._paged and self._slot_keys[slot]:
                # the prompt's full blocks now hold final K/V:
                # publish them so later prompts sharing the
                # prefix skip prefill (cache takes its own ref)
                for key, block in self._slot_keys[slot]:
                    self.pool.publish(key, block)
                self._slot_keys[slot] = []
        elif self._h_itl is not None:
            self._h_itl.observe(now - req.last_token_at)
        req.last_token_at = now

    def _host_drafts(self, live, depth) -> np.ndarray:
        """Prompt-lookup drafts on the host (speculate="ngram"): for each
        live slot, the continuation of the most recent earlier occurrence
        of its chain's last spec_ngram tokens (numpy, no device dispatch).
        Unconsumed prompt tokens draft as themselves (the forcing rule
        accepts them); without a match the current token repeats."""
        k = self.spec_depth
        n = self.spec_ngram
        drafts = np.zeros((self.n_slots, k), np.int32)
        for slot in live:
            d = int(depth[slot])
            if d < 1:
                continue
            idx = int(self._index[slot])
            lens = int(self._lens[slot])
            buf = self._spec_buf[slot]
            # positions idx+1 .. idx+d want proposals; prompt positions
            # are known
            row = drafts[slot]
            filled = 0
            while filled < d and idx + 1 + filled < lens:
                row[filled] = self._prompt[slot, idx + 1 + filled]
                filled += 1
            if filled >= d:
                continue
            fallback = int(self._tok[slot])
            cont = None
            if idx + 1 >= n:
                tail = buf[idx + 1 - n:idx + 1]
                # the committed chain is buf[:idx+1]; a match at p has its
                # continuation at p+n, itself committed history
                windows = np.lib.stride_tricks.sliding_window_view(buf[:idx + 1], n)
                hits = np.nonzero(
                    (windows[:idx + 1 - n] == tail).all(axis=1)
                )[0] if idx + 1 - n > 0 else np.empty(0, np.int64)
                if hits.size:
                    # the most recent occurrence whose continuation covers
                    # the window, else the earliest (the longest one)
                    need = d - filled
                    covering = hits[hits + n + need <= idx + 1]
                    m = int(covering[-1]) if covering.size else int(hits[0])
                    cont = buf[m + n:idx + 1]
            j = 0
            while filled < d:
                row[filled] = int(cont[j]) if cont is not None and j < len(cont) else fallback
                filled += 1
                j += 1
        return drafts

    def _spec_once(self, live) -> None:
        """One speculative round: propose up to each slot's depth of
        tokens (the draft model or the host lookup), score every window
        in ONE verify call, commit the longest accepted prefix plus the
        verify's own next token, and roll the rejected suffix back by
        resetting the slot's cursor alone (the next window rewrites those
        pool rows before anything reads them; no block moves)."""
        self.quanta += 1
        start = time.monotonic()
        k = self.spec_depth
        depth = np.zeros((self.n_slots,), np.int32)
        for slot in live:
            req = self._reqs[slot]
            # never past the request's budget: remaining tokens, one of
            # which the verify's correction supplies
            remaining = int(self._lens[slot]) + req.new - 1 - int(self._index[slot])
            depth[slot] = max(0, min(int(self._slot_depth[slot]), remaining - 1))
        try:
            if self.speculate == "draft":
                # d_max sequential draft steps, column by column; rows
                # that need fewer ignore the tail
                drafts = np.zeros((self.n_slots, k), np.int32)
                for j in range(int(depth.max())):
                    self.quantum_dispatches += 1
                    # a row at depth 0 near max_total steps on past the
                    # cache's end; its proposals are ignored, so its
                    # position clamps to the last row as the reference's
                    # dynamic_update_slice does (that row lies past the
                    # committed index, and is rewritten before it is read)
                    d_index = np.minimum(self._d_index, self.max_total - 1)
                    d_nxt = self.draft(self._d_tok, d_index, self._prompt,
                                       self._lens).cpu().numpy()
                    drafts[:, j] = d_nxt
                    self._d_tok[:] = d_nxt
                    self._d_index += 1
            else:
                drafts = self._host_drafts(live, depth)
            drafted = time.monotonic()
            toks = np.concatenate([self._tok[:, None], drafts], axis=1).astype(np.int32)
            self.quantum_dispatches += 1
            nxt = self.step.verify(toks, self._index, self._prompt, self._lens, self._tables)
            dispatched = time.monotonic()
            nxt = nxt.cpu().numpy()
        except Exception as err:  # noqa: BLE001 — fan out, stay alive
            self._fail_all(err)
            return
        synced = time.monotonic()
        self.decode_seconds += synced - start
        self.dispatch_seconds += dispatched - start
        self.sync_seconds += synced - dispatched
        self.spec_verify_seconds += synced - drafted
        if self._h_verify is not None:
            self._h_verify.observe(synced - start)
        self.steps += 1
        self.spec_rounds += 1
        slots_now = self.active_slots
        if self._h_batch is not None:
            self._h_batch.observe(slots_now)
        now = time.monotonic()
        proposed_now = accepted_now = 0
        for slot in live:
            req = self._reqs[slot]
            if req is None:
                continue
            d = int(depth[slot])
            # greedy acceptance: the longest prefix where the draft is the
            # verify's own argmax, then its one corrected token (a d == 0
            # row commits exactly the single-token step's result)
            accepted = 0
            while accepted < d and drafts[slot, accepted] == nxt[slot, accepted]:
                accepted += 1
            commit = accepted + 1
            self.spec_proposed += d
            self.spec_accepted += accepted
            proposed_now += d
            accepted_now += accepted
            if d > 0:
                hist = self._accept_hist[slot]
                hist.append(accepted / d)
                if len(hist) >= _SPEC_WIN // 2:
                    rate = sum(hist) / len(hist)
                    if rate < _SPEC_LOW:
                        self._slot_depth[slot] -= 1
                        self._depth_idle[slot] = 0
                        hist.clear()
                    elif rate > _SPEC_HIGH and self._slot_depth[slot] < self.spec_depth:
                        self._slot_depth[slot] += 1
                        hist.clear()
            index = int(self._index[slot])
            lens = int(self._lens[slot])
            final = lens + req.new - 1
            for j in range(commit):
                pos = index + 1 + j
                tok = int(nxt[slot, j])
                self._spec_buf[slot, pos] = tok
                if pos >= lens:
                    req._emit(tok)
                    self._post_emit(slot, req, now)
            self._tok[slot] = nxt[slot, commit - 1]
            self._index[slot] = index + commit
            self.row_steps += 1
            if index + commit >= final:
                self.finished += 1
                self._release(slot)
        if self.draft is not None:
            # resync the draft grid to the committed chains: rejected and
            # parked rows alike snap back
            self._d_tok[:] = self._tok
            self._d_index[:] = self._index
        if self._g_spec_depth is not None:
            for slot in range(self.n_slots):
                self._g_spec_depth.labels(slot=str(slot)).set(int(self._slot_depth[slot]))
        fanout = time.monotonic() - synced
        self.fanout_seconds += fanout
        default_flight().record(
            "serve", op="spec-step", step=self.steps, slots=slots_now,
            proposed=proposed_now, accepted=accepted_now,
            dispatch=round(dispatched - start, 6), sync=round(synced - dispatched, 6),
            fanout=round(fanout, 6),
        )



def main(argv=None) -> int:
    """Executable smoke: a tiny model with random weights from a seed,
    concurrent mixed-length requests through the engine, every chain
    checked equal to the inline generate() path, exactly one capture of
    each program; printed as JSON, exit 1 on any mismatch.

        python -m tf_operator_tpu_torch.serve.engine --smoke --layout paged --device cpu

    --mesh 1x2 (paged): the sharded step, whose mesh must form as asked
    (engine_mesh_devices) with a pool of 1/model shards a shard; a host
    with fewer devices puts several shards on one device.
    """
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--layout", choices=("paged", "dense"), default="dense")
    parser.add_argument("--block-size", type=int, default=64)
    parser.add_argument("--kv-blocks", type=int, default=0)
    parser.add_argument("--prefill-chunk", type=int, default=64)
    parser.add_argument("--device", default=None, help="default cuda; cpu runs the plain ops")
    parser.add_argument(
        "--mesh", default="",
        help="('batch','model') mesh shape for the sharded paged step, e.g. 1x2; a host "
        "with fewer devices puts several shards on one device",
    )
    parser.add_argument(
        "--speculate", choices=("off", "ngram", "draft"), default="off",
        help="speculative decoding: 'ngram' drafts from a host-side prompt lookup, "
        "'draft' from GPT_DRAFT (random weights from a seed)",
    )
    parser.add_argument("--spec-depth", type=int, default=4)
    parser.add_argument("--smoke", action="store_true",
                        help="accepted for CI-invocation clarity")
    args = parser.parse_args(argv)
    if args.speculate != "off" and args.layout != "paged":
        parser.error("--speculate requires --layout paged")
    mesh_shape = None
    if args.mesh:
        if args.layout != "paged":
            parser.error("--mesh requires --layout paged")
        mesh_shape = _parse_mesh_shape(args.mesh)

    from ..models import gpt as gpt_lib
    from ..parallel.mesh import short_host_devices

    device = resolve_device(args.device)
    cfg = gpt_lib.GPT_TINY
    model = gpt_lib.GPT(cfg, device=device, generator=torch.Generator().manual_seed(0))
    draft_model = None
    if args.speculate == "draft":
        # random draft weights: acceptance is near zero, and the chains
        # must equal the target's all the same
        draft_model = gpt_lib.GPT(gpt_lib.GPT_DRAFT, device=device,
                                  generator=torch.Generator().manual_seed(1))
    engine = ContinuousBatchingEngine(
        model, n_slots=args.slots, kv_layout=args.layout, block_size=args.block_size,
        kv_blocks=args.kv_blocks, prefill_chunk=args.prefill_chunk, device=device,
        speculate=args.speculate, spec_depth=args.spec_depth, draft_model=draft_model,
        mesh_shape=mesh_shape,
        mesh_devices=(short_host_devices(device, mesh_shape[0] * mesh_shape[1])
                      if mesh_shape else None),
    )
    paged = args.layout == "paged"
    rng = np.random.default_rng(0)
    jobs = []
    for _ in range(args.requests):
        p_len = int(rng.integers(1, 12))
        new = int(rng.integers(1, 8))
        row = rng.integers(0, cfg.vocab_size, size=p_len).tolist()
        jobs.append((row, new, engine.submit(row, new)))
    if paged:
        # shared-prefix traffic and one near-max prompt (chunked prefill)
        sys_blocks = max(1, min(3, (engine.max_total - 16) // args.block_size))
        system = rng.integers(0, cfg.vocab_size, size=sys_blocks * args.block_size).tolist()
        first = engine.submit(system, 4)
        jobs.append((system, 4, first))
        first.result(timeout=120)  # prefix blocks published at emit
        # repeat prompt -> whole-prompt cache hit -> copy-on-write
        jobs.append((system, 4, engine.submit(system, 4)))
        for i in range(3):
            tail = rng.integers(0, cfg.vocab_size, size=2 + i).tolist()
            jobs.append((system + tail, 4, engine.submit(system + tail, 4)))
        long_row = rng.integers(0, cfg.vocab_size, size=engine.max_total - 5).tolist()
        jobs.append((long_row, 4, engine.submit(long_row, 4)))
    mismatches = 0
    for row, new, req in jobs:
        got = req.result(timeout=120)
        want = gpt_lib.generate(model, torch.tensor([row]), new)[0].tolist()
        mismatches += got != want
    report = {
        "layout": args.layout,
        "device": str(device),
        "requests": len(jobs),
        "mismatches": mismatches,
        "compiles": engine.step.compiles,
        "steps": engine.steps,
    }
    ok = mismatches == 0 and engine.step.compiles == 1
    if paged:
        report["prefill_compiles"] = engine.step.prefill_compiles
        report["prefill_chunks"] = engine.prefill_chunks
        report["prefix_hits"] = engine.pool.hits
        report["cow_copies"] = engine.pool.cow_copies
        ok = ok and engine.step.prefill_compiles <= 1 and engine.pool.hits > 0
        if args.speculate != "off":
            report["verify_compiles"] = engine.step.verify_compiles
            report["spec_rounds"] = engine.spec_rounds
            report["spec_proposed"] = engine.spec_proposed
            report["spec_accepted"] = engine.spec_accepted
            ok = ok and engine.step.verify_compiles == 1 and engine.spec_rounds > 0
            if engine.draft is not None:
                report["draft_compiles"] = engine.draft.compiles
                ok = ok and engine.draft.compiles == 1
        if mesh_shape is not None:
            # the mesh formed as asked (no silent collapse) and a shard's
            # pool is exactly 1/N of the pool, read off the gauges
            gauges = engine.metrics()
            devices = gauges[("engine_mesh_devices", "gauge")]
            shards = gauges[("engine_mesh_model_shards", "gauge")]
            pool_bytes = gauges[("engine_kv_pool_bytes", "gauge")]
            shard_bytes = gauges[("engine_kv_shard_bytes", "gauge")]
            report.update(mesh_devices=devices, model_shards=shards, kv_pool_bytes=pool_bytes,
                          kv_shard_bytes=shard_bytes)
            ok = ok and devices == mesh_shape[0] * mesh_shape[1] and shards == mesh_shape[1]
            ok = ok and shard_bytes * shards == pool_bytes
        engine.stop()
        engine.pool.check()
        ok = ok and engine.pool.in_use() == 0
    else:
        engine.stop()
    report["ok"] = ok
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
