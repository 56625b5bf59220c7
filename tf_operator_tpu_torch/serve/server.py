"""Minimal decode server over the port's GPT and MoE LM. Counterpart of
tf_operator_tpu/serve/server.py: stdlib HTTP around models/gpt.py
`generate` (inline) or the continuous-batching engine (serve/engine.py),
and models/moe.py `moe_generate` for the moe presets.

    python -m tf_operator_tpu_torch.serve --preset tiny --port 8600 --device cpu
    python -m tf_operator_tpu_torch.serve --preset small --batching continuous \\
        --checkpoint-dir /ckpt/gpt
    python -m tf_operator_tpu_torch.serve --preset moe-base --checkpoint-dir /ckpt/moe
    python -m tf_operator_tpu_torch.serve --preset small --kv-int8 --weights-int8 \
        --batching continuous --speculate ngram --spec-depth 4
    python -m tf_operator_tpu_torch.serve --preset small --batching window \
        --batch-window-ms 5 --enable-debug-endpoints \
        --tenant-quotas '{"noisy": {"rate": 100, "burst": 200, "priority": "batch"}}'
    python -m tf_operator_tpu_torch.serve --preset small --batching continuous \
        --role prefill --port 8601      # and --role decode --port 8602
    python -m tf_operator_tpu_torch.serve --preset small \
        --checkpoint-dir /ckpt/gpt-int8   # a serve/export.py artifact

    POST /generate   {"input_ids": [[1,2,3], [7,8], ...],   # ragged OK
                      "max_new_tokens": 32, "temperature": 0.0,
                      "top_k": 0, "top_p": 1.0, "seed": 0, "num_beams": 1}
                  -> {"tokens": [[...], ...], "prompt_lens": [3, 2, ...]}
                  (num_beams > 1, greedy and uniform-length only: "tokens"
                  each row's best beam, plus "beams" and "beam_scores")
    POST /generate_stream  (single row) -> chunked ndjson: one
                  {"token": t, "index": i} event per generated token,
                  then {"done": true, "tokens": [[...]], "prompt_lens": [n]}
    POST /prefill   {"input_ids": [[...]], "migrate_to": "http://decode:port"?}
                  -> {"blocks": n, "migrated": bool, "imported": n}
    POST /kv/export {"input_ids": [[...]]} -> {"payload": <block set>|null,
                  "blocks": n}
    POST /kv/import <block set> -> {"imported": cached prefix blocks}
    GET  /kv/digest -> {"role", "block_size", "digest": [hash, ...]}
    GET  /kv/statz?top=N -> the paged pool's residency page
    GET  /healthz -> {"status": "ok"|"warming"|"draining", "role", ...} (200
                  while the process lives: liveness)
    GET  /readyz  -> 200 {"status": "ready"} only while admitting; 503
                  while warming and draining (readiness)
    GET  /metrics -> Prometheus text (the registry plus the engine's
                  counters)
    GET  /debug/trace -> Chrome/Perfetto trace-event JSON of request spans
    GET  /debug/clockz -> this process's monotonic, perf_counter and wall
                  clocks read back to back, and the tracer's epoch
    GET  /debug/flightz?request=&kind=&limit= -> flight records, JSONL
    GET  /debug/historyz?series=&window=&q=&points=1 -> the metric history
    GET  /debug/alertz?firing=1 -> the alert rules' states
    GET  /debug/profilez?action=start|stop|snapshot -> the sampling
                  profiler (only with --enable-debug-endpoints)

Ragged batches are first-class: rows are right-padded server-side and
each row's answer is its own prompt plus max_new_tokens.

--batching none (the default) decodes each request inline, serialized by
a lock; --batching window (serve/batching.py) holds a greedy request for
--batch-window-ms and decodes it with its compatible peers as one padded
batch; --batching continuous hands greedy requests to the engine, one
stream per row, admitted and evicted between single-token steps, tokens
streamed per request. Sampled requests keep the inline path, seeded
through a torch.Generator.

Telemetry, as the reference's: a metric history over the registry and
the engine's counters (--history-interval, --history-capacity), the
serve alert rules evaluated against it (--alerts, --ttft-slo-ms), and
per-tenant QoS at admission (--tenant-quotas: token-bucket quotas and
priority classes keyed by the X-Tenant header; a 429 always carries
Retry-After; the priority orders the engine's queue).

Everything runs on `--device` (cuda unless named; without a card the
server refuses to start rather than carry on on the CPU).

Decode modes, as the reference's: --kv-int8 (an int8 KV cache) and
--weights-int8 (the model quantized once at load; its f32 kernels are
not kept); --speculative (inline prompt-lookup speculation for
single-row uniform-length requests, the rest falling back to generate);
--speculate ngram|draft with --spec-depth and --draft-preset (the
engine's verify rounds; the draft presets share GPT_TINY's vocabulary,
so at --preset small draft mode is refused as the reference refuses it);
"num_beams" through beam_search.

The moe presets (moe-tiny, moe-base) serve plain greedy or sampled
decode of uniform-length prompts through `moe_generate`, inline; as in
the reference, a ragged request, top_k/top_p and beams are 400s, and
int8, speculation, window or continuous batching, a mesh and --tp are
refused at startup.

Disaggregated prefill/decode, as the reference's: --role prefill|decode
is advertised on /healthz and /kv/digest (the router, serve/router.py,
steers by it); every role serves every route. The migration routes need
--batching continuous with --kv-layout paged (a 400 otherwise). /prefill
ingests the prompt through the engine (one generated token publishes its
full-block prefix), exports the block set and, with migrate_to, ships it
to that replica's /kv/import; a failed ship is reported in the reply and
the flight recorder, never as a 5xx.

Checkpoints: --checkpoint-dir restores the newest step the port's
training CLIs wrote (train/trainer.py Checkpointer; train/gpt.py's for
the gpt presets, train/moe.py's for the moe ones), or a serve/export.py
artifact (int8 weights, served with weights_int8 on; its preset must be
--preset's); without one the server starts with random weights from a
seed and says so.

--smoke is the reference's telemetry smoke: GPT_TINY behind a continuous
server on --device, one streaming and one batch request, the /metrics,
/debug/trace and /debug/flightz contract, and the flight dump round-tripped
through `python -m tf_operator_tpu_torch.telemetry`; a JSON report, exit
0 or 1.

Sharded decode, as the reference's two ways:
- mesh_shape / --mesh-shape BxM (continuous batching, paged layout): the
  engine runs models/gpt.py ShardedPagedSlotDecodeStep over a
  ('batch','model') mesh of this process's devices (the CLI, on a host
  with fewer devices than the shape, puts several shards on one device,
  as the reference's CLI gives a short host virtual CPU devices).
  --mesh-shape and --weights-int8 are mutually exclusive.
- mesh / --tp N (inline decode): generate(mesh=) over a tensor-parallel
  world, one process a rank (parallel/mesh.py build_mesh), the world
  formed from the operator's environment as the training CLIs' --tp.
  make_server(mesh=) runs on every rank: on rank 0 it is the HTTP
  server, which broadcasts each decode call to the other ranks before
  it decodes; on the others a MeshFollower, whose serve_forever() makes
  the same generate(mesh=) calls until rank 0's server_close() tells it
  to stop. SIGTERM to rank 0 drains it and stops every rank, each
  exiting 0. mesh is exclusive with continuous batching and with
  speculative, in the reference's words.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import math
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from urllib.parse import parse_qs

from ..telemetry.flight import correlate, default_flight, render_flightz
from ..telemetry.profiler import default_profiler, render_profilez
from ..runtime.retry import RetryPolicy
from ..telemetry.tracecontext import TRACEPARENT_HEADER, parse_traceparent, trace_scope
from ..utils import locks

logger = logging.getLogger("tf_operator_tpu_torch.serve")

# request correlation IDs: every POST gets req-N, bound for the whole
# handler, threaded into the engine slot and its span, echoed back as
# "request_id"
_REQ_IDS = itertools.count(1)

MAX_BATCH = 64
# the ngram of the inline speculative path and its eligibility floor: one
# constant, so the gate never admits a prompt the drafter rejects
_SPEC_NGRAM = 2
# beams multiply the decode batch (and the KV cache) num_beams-fold
MAX_BEAMS = 8

# the moe family's refusals: the reference's texts
_MOE_STARTUP = (
    "the moe family serves plain decode only: kv_quant_int8, weights_int8, speculative, "
    "batching (window/continuous) and mesh are gpt-family features"
)
_MOE_FLAGS = "are gpt-family features; the moe presets serve plain greedy/sampled decode only"

# the routes of the disaggregated prefill/decode split (_do_migration)
_MIGRATION_ROUTES = ("/prefill", "/kv/export", "/kv/import")


def _family(model) -> str:
    """"moe" for the MoE LM, else "gpt": the one point that decode routing
    and per-family validation key on."""
    from ..models.moe import MoELM

    return "moe" if isinstance(model, MoELM) else "gpt"


def _max_seq(cfg) -> int:
    """The config's decode-length bound (GPTConfig.max_seq_len,
    MoEConfig.max_position_embeddings)."""
    return getattr(cfg, "max_seq_len", None) or cfg.max_position_embeddings


class _State:
    """Model + decode bookkeeping shared by request threads."""

    def __init__(self, model, model_name: str, max_new_cap: int, device,
                 kv_quant_int8: bool = False, weights_int8: bool = False,
                 speculative: bool = False, role: str = "") -> None:
        from ..telemetry import MetricRegistry, SpanTracer

        self.model = model
        self.kv_quant_int8 = kv_quant_int8
        self.weights_int8 = weights_int8
        self.speculative = speculative
        self.cfg = model.cfg
        self.family = _family(model)
        self.model_name = model_name
        self.max_new_cap = max_new_cap
        self.device = device
        # disaggregated prefill/decode: "" (monolithic), "prefill" or
        # "decode". Advisory: every role serves every route; the router
        # reads it from /healthz and /kv/digest
        self.role = role
        # "warming" -> "ready" -> "draining": POSTs are admitted only
        # while "ready"; a plain str store (atomic in CPython)
        self.phase = "warming"
        self.lock = locks.make_lock("_State.lock")
        self.engine = None  # set by make_server (batching="continuous")
        # make_server(mesh=): the tensor-parallel world's mesh; rank 0
        # broadcasts each inline decode call to the other ranks
        self.mesh = None
        # make_server(warm_async=True): the thread building the engine
        # (and capturing its programs) while the listener already answers
        self.warmup_thread = None
        # time.monotonic() when the phase first turned "ready"
        self.ready_at = None
        self.batcher = None  # set by make_server (batching="window")
        # per-tenant admission (TenantQoS), the metric history and the
        # alert manager over it, wired by make_server
        self.qos = None
        self.history = None
        self.alerts = None
        # /debug/profilez rides --enable-debug-endpoints
        self.enable_debug = False
        # the metric names are the reference's, so one scrape config
        # covers both servers
        self.registry = MetricRegistry("tf_operator_tpu_serve")
        self.tracer = SpanTracer(process_name="tf-operator-tpu-torch-serve")
        self.decodes = self.registry.counter(
            "decodes_total", "Decode requests answered successfully"
        )
        self.decode_batches = self.registry.counter(
            "decode_batches_total", "Device decode dispatches (inline path)",
        )
        self.tokens_generated = self.registry.counter(
            "generated_tokens_total", "Tokens generated across all rows"
        )
        self.decode_seconds = self.registry.counter(
            "decode_seconds_total", "Wall-clock seconds inside inline device decode calls",
        )
        self.request_errors = self.registry.counter(
            "request_errors_total",
            "Requests rejected (4xx) or failed during decode (5xx)",
        )
        self.decodes_inflight = self.registry.gauge(
            "decodes_inflight", "Device decodes dispatched and not yet finished",
        )
        self.speculative_decodes = self.registry.counter(
            "speculative_decodes_total",
            "Decodes that took the speculative prompt-lookup path",
        )

    def render_metrics(self) -> str:
        """Prometheus text: the registry, then the engine's flat counters
        (plain ints owned by its thread) as their own HELP/TYPE'd
        families."""
        out = self.registry.render()
        if self.engine is not None:
            from ..telemetry import format_value
            from .engine import METRIC_HELP

            rows = []
            for (name, kind), value in self.engine.metrics().items():
                full = self.registry.full_name(name)
                rows.append(f"# HELP {full} {METRIC_HELP.get(name, name)}")
                rows.append(f"# TYPE {full} {kind}")
                rows.append(f"{full} {format_value(value)}")
            out += "\n".join(rows) + "\n"
        return out


# the tenant header the admission layer reads; absent -> DEFAULT_TENANT
TENANT_HEADER = "X-Tenant"
DEFAULT_TENANT = "default"

# priority classes: name -> (engine priority, SLO-reject multiple). The
# engine priority orders the scheduler stage (higher overtakes lower while
# queued); the multiple scales the SLO-aware early-reject threshold, so
# batch work is shed first under queue pressure and high holds longest
PRIORITY_CLASSES = {
    "high": (2, 4.0),
    "standard": (1, 2.0),
    "batch": (0, 1.0),
}


class TenantQoS:
    """Per-tenant token-bucket quotas, priority classes and an SLO-aware
    early reject, enforced at POST admission.

    quotas: {tenant: {"rate": tokens/s, "burst": tokens, "priority":
    "high"|"standard"|"batch"}}; the "*" entry is the default for tenants
    not named (no "*": unnamed tenants are unmetered at standard
    priority). A request costs its worst-case generated tokens
    (max_new_tokens x rows), the unit the engine spends.

    Two reject paths, both HTTP 429 with a Retry-After the caller can
    trust:
    - bucket empty: Retry-After is the time for the bucket to refill to
      the request's cost;
    - queue pressure: the queue-wait p95 over the last minute
      (history.quantile_over_window) past the class's multiple of the
      TTFT SLO; Retry-After is that projected wait.
    Both are capped at RETRY_AFTER_CAP."""

    def __init__(
        self,
        quotas,
        ttft_slo_s: float = 0.25,
        history=None,
        registry=None,
        queue_wait_series: str = "tf_operator_tpu_serve_queue_wait_seconds",
        queue_window_s: float = 60.0,
        clock=None,
    ) -> None:
        self.clock = clock if clock is not None else time
        self.ttft_slo_s = float(ttft_slo_s)
        self.history = history
        self.queue_wait_series = queue_wait_series
        self.queue_window_s = float(queue_window_s)
        self.quotas = {}
        for tenant, quota in (quotas or {}).items():
            cls = quota.get("priority", "standard")
            if cls not in PRIORITY_CLASSES:
                raise ValueError(
                    f"tenant {tenant!r}: priority must be one of "
                    f"{sorted(PRIORITY_CLASSES)}, got {cls!r}"
                )
            rate = quota.get("rate")
            if rate is not None and float(rate) <= 0:
                raise ValueError(f"tenant {tenant!r}: rate must be > 0, got {rate}")
            self.quotas[str(tenant)] = {
                "rate": float(rate) if rate is not None else None,
                "burst": float(quota.get("burst", (rate or 0) * 2 or 1)),
                "priority": cls,
            }
        self._lock = locks.make_lock("TenantQoS._lock")
        # tenant -> (bucket level, last refill monotonic)
        self._buckets = {}
        self._c_requests = None
        self._c_rejected = None
        if registry is not None:
            self._c_requests = registry.counter(
                "tenant_requests_total", "Decode requests seen at admission, by tenant",
                labelnames=("tenant",),
            )
            self._c_rejected = registry.counter(
                "tenant_rejected_total", "Requests early-rejected with 429, by tenant",
                labelnames=("tenant",),
            )

    def _quota(self, tenant: str):
        return self.quotas.get(tenant) or self.quotas.get("*")

    def priority(self, tenant: str) -> int:
        quota = self._quota(tenant)
        return PRIORITY_CLASSES[quota["priority"] if quota else "standard"][0]

    def admit(self, tenant: str, cost: float) -> dict:
        """-> {"ok": True, "priority": n} or {"ok": False, "retry_after":
        s, "reason": ...}. Counts the request either way; the caller
        turns a reject into the 429 reply."""
        from ..runtime.retry import RETRY_AFTER_CAP

        if self._c_requests is not None:
            self._c_requests.labels(tenant=tenant).inc()
        quota = self._quota(tenant)
        cls = quota["priority"] if quota else "standard"
        priority, slo_multiple = PRIORITY_CLASSES[cls]

        # SLO-aware early reject: when the queue already makes requests
        # wait past this class's budget, say so now, with a projection
        if self.history is not None:
            projected = self.history.quantile_over_window(
                self.queue_wait_series, 0.95, self.queue_window_s
            )
            if projected is not None and projected > slo_multiple * self.ttft_slo_s:
                if self._c_rejected is not None:
                    self._c_rejected.labels(tenant=tenant).inc()
                return {
                    "ok": False,
                    "reason": (
                        f"queue wait p95 {projected:.3f}s exceeds {slo_multiple:g}x the "
                        f"{self.ttft_slo_s:g}s TTFT SLO for priority {cls!r}"
                    ),
                    "retry_after": min(RETRY_AFTER_CAP, max(1.0, projected)),
                }

        if quota is None or quota["rate"] is None:
            return {"ok": True, "priority": priority}
        now = self.clock.monotonic()
        with self._lock:
            level, last = self._buckets.get(tenant, (quota["burst"], now))
            level = min(quota["burst"], level + quota["rate"] * (now - last))
            if level >= cost:
                self._buckets[tenant] = (level - cost, now)
                return {"ok": True, "priority": priority}
            self._buckets[tenant] = (level, now)
            wait = (cost - level) / quota["rate"]
        if self._c_rejected is not None:
            self._c_rejected.labels(tenant=tenant).inc()
        return {
            "ok": False,
            "reason": (
                f"tenant {tenant!r} over its token budget "
                f"({quota['rate']:g} tokens/s, burst {quota['burst']:g})"
            ),
            "retry_after": min(RETRY_AFTER_CAP, max(1.0, wait)),
        }


def _bad(payload) -> tuple:
    return 400, {"error": payload}


def _validate(state: _State, body):
    """-> (right-padded prompt array, per-row lens list, max_new_tokens,
    temperature, seed, top_k, top_p, num_beams) or (status, err). Every malformed
    field is a 400, never a dropped connection."""
    import numpy as np

    if not isinstance(body, dict):
        return _bad("request body must be a JSON object")
    ids = body.get("input_ids")
    if not isinstance(ids, list) or not ids:
        return _bad("input_ids must be a non-empty list of token lists")
    if not all(isinstance(row, list) and row for row in ids):
        return _bad("every input_ids row must be a non-empty token list")
    if not all(
        isinstance(tok, int) and not isinstance(tok, bool) for row in ids for tok in row
    ):
        return _bad("every token must be an integer")
    if len(ids) > MAX_BATCH:
        return _bad(f"batch {len(ids)} exceeds cap {MAX_BATCH}")
    if any(tok < 0 or tok >= state.cfg.vocab_size for row in ids for tok in row):
        return _bad(f"token ids must be in [0, {state.cfg.vocab_size})")
    # right-pad to the longest row; generate() takes the true lengths
    lens = [len(row) for row in ids]
    width = max(lens)
    prompt = np.zeros((len(ids), width), dtype=np.int32)
    for i, row in enumerate(ids):
        prompt[i, :len(row)] = row
    new = body.get("max_new_tokens", 16)
    if not isinstance(new, int) or isinstance(new, bool) or not (1 <= new <= state.max_new_cap):
        return _bad(f"max_new_tokens must be an int in [1, {state.max_new_cap}]")
    if width + new > _max_seq(state.cfg):
        return _bad(
            f"prompt_len {width} + max_new_tokens {new} "
            f"exceeds max_seq_len {_max_seq(state.cfg)}"
        )
    temperature = body.get("temperature", 0.0)
    if not isinstance(temperature, (int, float)) or isinstance(temperature, bool) \
            or temperature < 0:
        return _bad("temperature must be a number >= 0")
    seed = body.get("seed", 0)
    if not isinstance(seed, int) or isinstance(seed, bool):
        return _bad("seed must be an integer")
    top_k = body.get("top_k", 0)
    if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k < 0:
        return _bad("top_k must be an integer >= 0")
    top_p = body.get("top_p", 1.0)
    if not isinstance(top_p, (int, float)) or isinstance(top_p, bool) or (
        not 0.0 < float(top_p) <= 1.0
    ):
        return _bad("top_p must be in (0, 1]")
    num_beams = body.get("num_beams", 1)
    if not isinstance(num_beams, int) or isinstance(num_beams, bool) or (
        not 1 <= num_beams <= MAX_BEAMS
    ):
        return _bad(f"num_beams must be an int in [1, {MAX_BEAMS}]")
    if num_beams > 1:
        if temperature != 0 or top_k != 0 or float(top_p) != 1.0:
            return _bad("num_beams > 1 requires greedy settings (temperature 0, no top_k/top_p)")
        if any(length != width for length in lens):
            return _bad("num_beams > 1 requires uniform-length prompts")
        if len(ids) * num_beams > MAX_BATCH:
            # beams ride the batch axis: the product is what the card sees
            return _bad(
                f"batch {len(ids)} x num_beams {num_beams} exceeds the device admission "
                f"cap {MAX_BATCH}"
            )
    if state.family == "moe":
        # moe_generate decodes uniform-length prompts, greedy or tempered
        if any(length != width for length in lens):
            return _bad("the moe family requires uniform-length prompts "
                        "(no ragged prompt_lens machinery in moe_generate)")
        if top_k != 0 or float(top_p) != 1.0:
            return _bad("top_k/top_p are not supported for the moe family")
        if num_beams > 1:
            return _bad("beam search is not supported for the moe family")
    return prompt, lens, new, float(temperature), seed, top_k, float(top_p), num_beams


def _device_decode(state: _State, prompt, lens, new, temperature=0.0, seed=0,
                   top_k=0, top_p=1.0, num_beams=1):
    """The inline decode-and-account block, shared by /generate,
    /generate_stream and beams: -> host chains [b, width + new] (numpy),
    or for num_beams > 1 beam_search's host (sequences, scores).

    The speculative path (--speculative) takes single-row uniform-length
    requests only: its rounds commit the batch minimum of the rows'
    accepted drafts, so one low-acceptance row would hold every row to one
    token a round; multi-row and ragged requests fall back to generate.
    Greedy requests are token-exact against generate (at f32); sampled
    ones are distribution-exact from another stream of the seed's
    generator."""
    use_spec = (
        num_beams == 1 and state.speculative and len(lens) == 1
        and lens[0] == prompt.shape[1] and prompt.shape[1] >= _SPEC_NGRAM
    )
    state.decodes_inflight.inc()
    try:
        return _locked_decode(state, prompt, lens, new, temperature, seed, top_k, top_p,
                              num_beams, use_spec)
    finally:
        state.decodes_inflight.dec()


def _locked_decode(state, prompt, lens, new, temperature, seed, top_k, top_p,
                   num_beams=1, use_spec=False):
    call = {"prompt": prompt, "lens": [int(n) for n in lens], "new": int(new),
            "temperature": float(temperature), "seed": int(seed), "top_k": int(top_k),
            "top_p": float(top_p), "num_beams": int(num_beams), "use_spec": bool(use_spec)}
    with state.lock:  # decode saturates the card; serialize
        start = time.monotonic()
        if state.mesh is not None:
            # every rank of the mesh makes the same call
            _broadcast_call(call)
        out = _run_decode(state, call)
        state.decode_seconds.inc(time.monotonic() - start)
        state.decode_batches.inc()
        if use_spec:
            state.speculative_decodes.inc()
    return out


def _run_decode(state, call: dict):
    """One inline decode call (_locked_decode's, or one rank 0 broadcast
    to a MeshFollower) -> host chains, or beam_search's host (sequences,
    scores)."""
    import torch

    from ..models import gpt as gpt_lib
    from ..models import moe as moe_lib

    new, temperature = call["new"], call["temperature"]
    top_k, top_p = call["top_k"], call["top_p"]
    generator = torch.Generator(device=state.device).manual_seed(call["seed"])
    tokens = torch.as_tensor(call["prompt"], device=state.device)
    flags = dict(kv_quant_int8=state.kv_quant_int8, weights_int8=state.weights_int8)
    if state.family == "moe":
        out = moe_lib.moe_generate(
            state.model, tokens, new, temperature=temperature, generator=generator,
        )
    elif call["num_beams"] > 1:
        seqs, scores = gpt_lib.beam_search(state.model, tokens, new,
                                           num_beams=call["num_beams"], **flags)
        return seqs.cpu().numpy(), scores.cpu().numpy()
    elif call["use_spec"]:
        out = gpt_lib.generate_speculative(
            state.model, tokens, new, ngram=_SPEC_NGRAM, temperature=temperature,
            generator=generator, top_k=top_k, top_p=top_p, **flags,
        )
    else:
        out = gpt_lib.generate(
            state.model, tokens, new, temperature=temperature, generator=generator,
            prompt_lens=torch.tensor(call["lens"]), top_k=top_k, top_p=top_p,
            mesh=state.mesh, **flags,
        )
    return out.cpu().numpy()  # waits for the device


def _broadcast_call(call) -> Optional[dict]:
    """Rank 0's decode call (None: stop) to every rank of the world, over
    its host side; -> the call, on every rank."""
    import torch
    import torch.distributed as dist

    box = [call]
    dist.broadcast_object_list(box, src=0, device=torch.device("cpu"))
    return box[0]


class MeshFollower:
    """make_server(mesh=) on a rank other than 0: no listener; its
    serve_forever() makes each decode call rank 0 broadcasts, with the
    same arguments (generate(mesh=)'s collectives need every rank), until
    rank 0's server_close() broadcasts the stop. A call that raises on
    rank 0 raises here too, before any collective, and is skipped."""

    def __init__(self, state: _State) -> None:
        self.state = state
        self.calls = 0

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self.state.phase = "ready"
        while True:
            call = _broadcast_call(None)
            if call is None:
                return
            self.calls += 1
            try:
                _run_decode(self.state, call)
            except ValueError as err:
                logger.info("follower: the call was refused: %s", err)

    def shutdown(self) -> None:
        """Nothing to stop: rank 0's server_close() ends serve_forever."""

    def server_close(self) -> None:
        self.state.phase = "draining"


def DecodeHandlerFactory(state: _State):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # idle keep-alive connections close after this many seconds, so
        # a persistent client cannot park a handler thread forever and
        # hang the SIGTERM drain
        timeout = 5
        # a request body in flight gets a roomier budget
        body_timeout = 60

        # per-connection state: the correlation ID and fleet trace id of
        # the POST being handled
        _request_corr = None
        _request_trace = None

        def _reply(self, code: int, payload: dict, headers=None) -> None:
            if self._request_corr is not None:
                payload.setdefault("request_id", self._request_corr)
            if self._request_trace is not None:
                payload.setdefault("trace_id", self._request_trace)
            self._send(code, "application/json", json.dumps(payload).encode(), headers)

        def _send(self, code: int, ctype: str, body: bytes, headers=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str) -> None:
            state.request_errors.inc()
            self._reply(code, {"error": message})

        def do_GET(self) -> None:  # noqa: N802
            self._request_corr = None
            self._request_trace = None
            route, _, query = self.path.partition("?")
            if route == "/healthz":
                # liveness stays 200 through warmup and drain; the status
                # says the truth ("ok" only while admitting), and a failed
                # BlockPool audit makes it "degraded"
                engine = state.engine
                audit_ok = bool(engine is None or engine.pool_audit_ok)
                status = "ok" if state.phase == "ready" else state.phase
                if not audit_ok:
                    status = "degraded"
                payload = {
                    "status": status, "model": state.model_name, "role": state.role,
                    "device": str(state.device),
                    "decodes": int(state.decodes.value),
                    "pool_audit": "ok" if audit_ok else "failed",
                    "kv_int8": state.kv_quant_int8, "weights_int8": state.weights_int8,
                }
                if not audit_ok:
                    payload["pool_audit_error"] = str(engine.pool_audit_error)[:200]
                    payload["pool_audit_failures"] = int(engine.pool_audit_failures)
                self._reply(200, payload)
            elif route == "/readyz":
                phase = state.phase
                self._reply(200 if phase == "ready" else 503,
                            {"status": phase, "model": state.model_name})
            elif route == "/kv/digest":
                # the rolling prefix digest the router scores overlap
                # with; a server without a paged engine answers an empty
                # one (the same wire shape, nothing to share)
                engine = state.engine
                if engine is None or engine.pool is None:
                    return self._reply(200, {"role": state.role, "block_size": 0, "digest": []})
                self._reply(200, {"role": state.role, "block_size": int(engine.pool.block_size),
                                  "digest": engine.prefix_digest()})
            elif route == "/kv/statz":
                # the pool's residency page; ?top=N widens its hot-prefix
                # table
                engine = state.engine
                if engine is None or engine.pool is None:
                    return self._reply(200, {"role": state.role, "paged": False})
                try:
                    top_n = int((parse_qs(query).get("top") or ["10"])[0])
                except ValueError:
                    return self._reply(400, {"error": "?top= must be an integer"})
                page = engine.kv_statz(top_n=top_n)
                page["role"] = state.role
                self._reply(200, page)
            elif route == "/metrics":
                self._send(200, "text/plain; version=0.0.4", state.render_metrics().encode())
            elif route == "/debug/trace":
                # recent request spans (queued -> admitted -> first-token
                # -> finished); load in ui.perfetto.dev as-is
                self._send(200, "application/json",
                           json.dumps(state.tracer.export_chrome()).encode())
            elif route == "/debug/clockz":
                # this process's clocks read back to back, and the span
                # tracer's perf_counter epoch, so that span timestamps map
                # onto the flight records' monotonic axis
                self._reply(200, {
                    "mono": time.monotonic(), "perf": time.perf_counter(),
                    "wall": time.time(), "tracer_epoch_perf": state.tracer._epoch,
                    "pid": os.getpid(),
                })
            elif route == "/debug/flightz":
                # request shapes, not payloads: ungated. Resolved per
                # request, so a recorder swapped in later is the one served
                self._send(200, "application/x-ndjson", render_flightz(default_flight(), query))
            elif route == "/debug/historyz":
                if state.history is None:
                    return self._reply(404, {"error": "history not enabled"})
                from ..telemetry import render_historyz

                self._send(200, "application/json", render_historyz(state.history, query))
            elif route == "/debug/alertz":
                if state.alerts is None:
                    return self._reply(404, {"error": "alerts not enabled"})
                from ..telemetry import render_alertz

                self._send(200, "application/json", render_alertz(state.alerts, query))
            elif route == "/debug/profilez" and state.enable_debug:
                # live thread stacks: behind --enable-debug-endpoints
                self._send(200, *render_profilez(default_profiler(), query))
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        # -- chunked ndjson streaming (/generate_stream) --------------

        def _start_stream(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _stream_event(self, payload: dict) -> None:
            data = json.dumps(payload).encode() + b"\n"
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()  # one chunk per event: the flush IS the streaming

        def _end_stream(self) -> None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def do_POST(self) -> None:  # noqa: N802
            # one correlation ID per request, bound for the whole handler;
            # a traceparent header joins this hop to the caller's trace,
            # else a fresh trace starts here
            corr = f"req-{next(_REQ_IDS)}"
            self._request_corr = corr
            parent = parse_traceparent(self.headers.get(TRACEPARENT_HEADER))
            try:
                with correlate(corr), trace_scope(parent=parent) as ctx:
                    self._request_trace = ctx.trace_id
                    default_flight().record("serve", corr=corr, op="request", path=self.path)
                    self._handle_post()
            finally:
                self._request_corr = None
                self._request_trace = None

        def _handle_post(self) -> None:
            if self.path not in ("/generate", "/generate_stream") + _MIGRATION_ROUTES:
                return self._reply(404, {"error": f"no route {self.path}"})
            if state.phase != "ready":
                # warming or draining: refuse new work loudly (503 is in
                # the client's retryable class)
                return self._error(503, f"server is {state.phase}")
            try:
                length = int(self.headers.get("Content-Length") or 0)
                # widen the socket budget for the upload only
                self.connection.settimeout(self.body_timeout)
                try:
                    raw = self.rfile.read(length) if length else b""
                finally:
                    self.connection.settimeout(self.timeout)
                body = json.loads(raw or b"{}")
            except (ValueError, json.JSONDecodeError) as err:
                return self._error(400, f"bad JSON: {err}")
            if self.path in _MIGRATION_ROUTES:
                return self._do_migration(self.path, body)
            result = _validate(state, body)
            if isinstance(result[0], int):  # (status, payload)
                return self._error(result[0], result[1]["error"])
            prompt, lens, new, temperature, seed, top_k, top_p, num_beams = result
            # per-tenant QoS admission before any engine or batcher work is
            # queued; a 429 always carries Retry-After
            tenant = (self.headers.get(TENANT_HEADER) or DEFAULT_TENANT).strip() or DEFAULT_TENANT
            priority = 0
            if state.qos is not None:
                verdict = state.qos.admit(tenant, new * len(lens))
                if not verdict["ok"]:
                    state.request_errors.inc()
                    retry_after = verdict["retry_after"]
                    default_flight().record(
                        "serve", op="early-reject", tenant=tenant,
                        retry_after=round(retry_after, 3), reason=verdict["reason"][:120],
                    )
                    return self._reply(
                        429, {"error": verdict["reason"], "tenant": tenant,
                              "retry_after": round(retry_after, 3)},
                        headers={"Retry-After": str(int(math.ceil(retry_after)))},
                    )
                priority = verdict["priority"]
            if self.path == "/generate_stream":
                if num_beams > 1 and len(lens) == 1:
                    return self._error(400, "/generate_stream does not support beams")
                return self._do_stream(prompt, lens, new, temperature, seed, top_k, top_p,
                                       priority)
            if num_beams > 1:
                # through the shared inline block, never the engine: beams
                # already multiply the device batch num_beams-fold
                try:
                    seqs, scores = _device_decode(state, prompt, lens, new,
                                                  num_beams=num_beams)
                except Exception as err:  # noqa: BLE001 — same contract
                    return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
                state.decodes.inc()
                # every beam's tokens: the device work covers all of them
                state.tokens_generated.inc(new * num_beams * len(lens))
                return self._reply(200, {
                    "tokens": [row[0].tolist() for row in seqs],
                    "beams": [row.tolist() for row in seqs],
                    "beam_scores": [row.tolist() for row in scores],
                    "prompt_lens": lens,
                })
            greedy = temperature == 0.0 and top_k == 0 and top_p == 1.0
            if state.engine is not None and greedy:
                # continuous batching: each row becomes its own engine
                # stream, admitted into a free slot between steps
                try:
                    chains = state.engine.generate(prompt, lens, new, priority=priority)
                except ValueError as err:
                    # the engine judged the request invalid (oversized
                    # prompt, over-budget KV reservation): client error
                    return self._error(400, str(err))
                except TimeoutError as err:
                    return self._error(503, str(err))
                except Exception as err:  # noqa: BLE001 — a device failure
                    # fans out to every in-flight client as JSON; the
                    # engine zeroes its cache and stays up
                    return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
                state.decodes.inc()
                state.tokens_generated.inc(new * len(lens))
                return self._reply(200, {"tokens": chains, "prompt_lens": lens})
            if state.batcher is not None and greedy:
                # window batching: greedy requests coalesce into one
                # decode (serve/batching.py); sampled ones keep the inline
                # path, so that their generator streams stay per request
                try:
                    tokens = state.batcher.submit(prompt, lens, new)
                except TimeoutError as err:
                    return self._error(503, str(err))
                except Exception as err:  # noqa: BLE001 — fans out to every
                    # coalesced client as JSON
                    return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
                state.decodes.inc()
                state.tokens_generated.inc(new * len(lens))
                return self._reply(200, {"tokens": tokens, "prompt_lens": lens})
            try:
                chains = _device_decode(state, prompt, lens, new, temperature=temperature,
                                        seed=seed, top_k=top_k, top_p=top_p)
            except Exception as err:  # noqa: BLE001 — same contract
                return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
            state.decodes.inc()
            state.tokens_generated.inc(new * len(lens))
            # each row's answer is its own prompt plus max_new tokens
            tokens = [chains[i, :lens[i] + new].tolist() for i in range(len(lens))]
            self._reply(200, {"tokens": tokens, "prompt_lens": lens})

        def _do_migration(self, route: str, body) -> None:
            """The disaggregated prefill/decode routes, all on the paged
            continuous engine (the paged layout is what makes KV a
            serializable block set):

                POST /kv/export {"input_ids": [[...]]}
                    -> {"payload": <block set>|null, "blocks": n}
                POST /kv/import <block set>
                    -> {"imported": cached_prefix_blocks}
                POST /prefill   {"input_ids": [[...]],
                                 "migrate_to": "http://decode:port"?}
                    -> {"blocks": n, "migrated": bool, "imported": n}

            /prefill runs chunked prefill to completion (a 1-token decode
            publishes the prompt's full-block prefix into the prefix
            cache), exports the block set and, when migrate_to names a
            decode replica, ships it there. A failed ship is reported in
            the reply and flight-recorded, never a 5xx: the router
            degrades to the monolithic path on it."""
            engine = state.engine
            if engine is None or engine.pool is None:
                return self._error(
                    400, f"{route} requires --batching continuous with --kv-layout paged")
            if route == "/kv/import":
                try:
                    imported = engine.import_prefix_blocks(body, corr=self._request_corr)
                except ValueError as err:
                    return self._error(400, str(err))
                except Exception as err:  # noqa: BLE001 — JSON, never a dropped socket
                    return self._error(500, f"import failed: {type(err).__name__}: {err}"[:300])
                return self._reply(200, {"imported": imported})
            result = _validate(state, body)
            if isinstance(result[0], int):
                return self._error(result[0], result[1]["error"])
            prompt, lens = result[0], result[1]
            if len(lens) != 1:
                return self._error(400, f"{route} takes exactly one prompt row")
            row = prompt[0, :lens[0]].tolist()
            if route == "/kv/export":
                try:
                    payload = engine.export_prefix_blocks(row, corr=self._request_corr)
                except Exception as err:  # noqa: BLE001
                    return self._error(500, f"export failed: {type(err).__name__}: {err}"[:300])
                return self._reply(200, {
                    "payload": payload, "blocks": 0 if payload is None else payload["blocks"],
                })
            # /prefill: the prompt through the engine's chunked prefill
            # (1 generated token; its release publishes the full-block
            # prefix into the prefix cache), then export and maybe ship
            try:
                req = engine.submit(row, 1, corr=self._request_corr)
                for _ in req.stream():
                    pass
                payload = engine.export_prefix_blocks(row, corr=self._request_corr)
            except ValueError as err:
                return self._error(400, str(err))
            except TimeoutError as err:
                return self._error(503, str(err))
            except Exception as err:  # noqa: BLE001
                return self._error(500, f"prefill failed: {type(err).__name__}: {err}"[:300])
            state.decodes.inc()
            state.tokens_generated.inc(1)
            out = {
                "blocks": 0 if payload is None else payload["blocks"],
                "migrated": False,
                "imported": 0,
            }
            migrate_to = body.get("migrate_to")
            if payload is not None and migrate_to:
                from .client import DecodeClient

                try:
                    resp = DecodeClient(
                        str(migrate_to), timeout=self.body_timeout,
                        # fail fast: the router owns the degradation, and a
                        # handler blocked on retry backoff holds the
                        # caller's TTFT
                        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.2),
                    ).kv_import(payload)
                    out["migrated"] = True
                    out["imported"] = int(resp.get("imported", 0))
                except Exception as err:  # noqa: BLE001 — the blocks stay
                    # cached here; the caller decodes on any replica
                    default_flight().record(
                        "serve", op="migrate-failed", target=str(migrate_to),
                        error=f"{type(err).__name__}: {err}"[:200],
                    )
                    out["error"] = f"migrate failed: {type(err).__name__}: {err}"[:300]
            return self._reply(200, out)

        def _do_stream(self, prompt, lens, new, temperature, seed, top_k, top_p,
                       priority=0) -> None:
            """/generate_stream: chunked ndjson, one event per generated
            token. With the engine, events leave as the engine produces
            them; on the inline path the decode is whole, so the tokens
            leave in one burst at the end (same wire contract)."""
            if len(lens) != 1:
                return self._error(
                    400, "/generate_stream takes exactly one prompt row (one stream per connection)"
                )
            greedy = temperature == 0.0 and top_k == 0 and top_p == 1.0
            if state.engine is not None and greedy:
                try:
                    req = state.engine.submit(prompt[0, :lens[0]].tolist(), new,
                                              priority=priority, wire=True)
                except ValueError as err:
                    # invalid request: reject before the 200 is on the wire
                    return self._error(400, str(err))
                except Exception as err:  # noqa: BLE001 — pre-stream
                    return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
                self._start_stream()
                try:
                    index = lens[0]
                    for token in req.stream():
                        self._stream_event({"token": token, "index": index})
                        if index == lens[0]:
                            req.on_wire()
                        index += 1
                    self._stream_event({
                        "done": True, "tokens": [req.prompt + req.tokens], "prompt_lens": lens,
                        "request_id": self._request_corr, "trace_id": self._request_trace,
                    })
                    self._end_stream()
                except (BrokenPipeError, ConnectionError, OSError, ValueError) as err:
                    # the client went away mid-stream: cancel so the slot
                    # frees before the next step
                    req.cancel()
                    logger.info("stream client gone: %s", err)
                    self.close_connection = True
                    return
                except Exception as err:  # noqa: BLE001 — the 200 is on
                    # the wire; the error rides the stream as its own
                    # terminal event
                    state.request_errors.inc()
                    try:
                        self._stream_event(
                            {"error": f"decode failed: {type(err).__name__}: {err}"[:300]}
                        )
                        self._end_stream()
                    except (OSError, ValueError):
                        self.close_connection = True
                    return
                state.decodes.inc()
                state.tokens_generated.inc(new)
                return
            try:
                if state.batcher is not None and greedy:
                    chain = state.batcher.submit(prompt, lens, new)[0]
                else:
                    chains = _device_decode(state, prompt, lens, new, temperature=temperature,
                                            seed=seed, top_k=top_k, top_p=top_p)
                    chain = chains[0, :lens[0] + new].tolist()
            except TimeoutError as err:
                return self._error(503, str(err))
            except Exception as err:  # noqa: BLE001 — same contract
                return self._error(500, f"decode failed: {type(err).__name__}: {err}"[:300])
            state.decodes.inc()
            state.tokens_generated.inc(new)
            try:
                self._start_stream()
                for i, token in enumerate(chain[lens[0]:]):
                    self._stream_event({"token": int(token), "index": lens[0] + i})
                self._stream_event({
                    "done": True, "tokens": [chain], "prompt_lens": lens,
                    "request_id": self._request_corr, "trace_id": self._request_trace,
                })
                self._end_stream()
            except (BrokenPipeError, ConnectionError):
                self.close_connection = True

        def log_message(self, *args) -> None:
            pass

    return Handler


class DecodeHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks live connection sockets;
    abort_connections() severs every in-flight connection with an RST
    (SO_LINGER 0), the in-process analog of a replica killed with exit
    137."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conn_lock = locks.make_lock("DecodeHTTPServer._conn_lock")
        self._conns: set = set()
        # the handler threads still running (daemon threads, which
        # server_close does not join): join_handlers waits for them
        self._handlers: set = set()

    def server_close(self):
        # the history and alert tick threads and the batcher end with the
        # listener, so a shutdown leaves no thread behind
        state = getattr(self, "state", None)
        if state is not None:
            # an engine still being built under warm_async is waited
            # for, so the caller's engine.stop() finds it
            warmup = state.warmup_thread
            if warmup is not None and warmup.is_alive():
                warmup.join(timeout=120.0)
            for owner in (state.alerts, state.history, state.batcher):
                if owner is not None:
                    owner.stop()
            if state.mesh is not None:
                # the mesh's other ranks (MeshFollower) stop with rank 0
                with state.lock:
                    _broadcast_call(None)
                state.mesh = None
        super().server_close()

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        me = threading.current_thread()
        with self._conn_lock:
            self._handlers.add(me)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conn_lock:
                self._handlers.discard(me)

    def join_handlers(self, timeout: float = 10.0) -> int:
        """Wait (up to `timeout` in all) for the handler threads still
        running, whose frames hold the server's state and engine; -> how
        many are still alive after."""
        deadline = time.monotonic() + timeout
        with self._conn_lock:
            threads = list(self._handlers)
        for thread in threads:
            thread.join(max(0.0, deadline - time.monotonic()))
        return sum(1 for thread in threads if thread.is_alive())

    def shutdown_request(self, request):
        with self._conn_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def abort_connections(self) -> int:
        """Hard-close every live connection; -> how many were severed."""
        import socket as socket_mod
        import struct

        with self._conn_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                # linger(on, 0): close() sends RST instead of FIN
                sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_LINGER,
                                struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        return len(conns)

    def handle_error(self, request, client_address):
        # severed sockets make handler threads die on writes; expected
        # during abort_connections/drain
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, BrokenPipeError, OSError, ValueError)):
            return
        super().handle_error(request, client_address)


def make_server(
    model,
    port: int = 0,
    model_name: str = "gpt",
    max_new_cap: int = 1024,
    host: str = "127.0.0.1",
    batching: str = "",
    n_slots: int = 8,
    warm_async: bool = False,
    kv_layout: str = "paged",
    block_size: int = 64,
    kv_blocks: int = 0,
    prefill_chunk: int = 64,
    device=None,
    kv_quant_int8: bool = False,
    weights_int8: bool = False,
    batch_window_ms: float = 0.0,
    speculative: bool = False,
    speculate: str = "off",
    spec_depth: int = 4,
    draft_preset: str = "",
    mesh=None,
    mesh_shape=None,
    mesh_devices=None,
    role: str = "",
    tenant_quotas=None,
    enable_debug_endpoints: bool = False,
    history_capacity: int = 512,
    history_interval_s: float = 0.0,
    alerts: bool = True,
    alert_rules=None,
    ttft_slo_s: float = 0.25,
) -> DecodeHTTPServer:
    """In-process server over the port's GPT or MoE LM module (tests and
    embedders); the caller owns serve_forever/shutdown (and, with an
    engine, `server.state.engine.stop()`). The CLI binds 0.0.0.0; the
    in-process default stays loopback. batching: "none" (inline,
    lock-serialized), "window" (serve/batching.py DynamicBatcher; needs
    batch_window_ms > 0) or "continuous" (serve/engine.py: the slot grid,
    built here, its programs captured before the server answers, or
    with warm_async on a warm-up thread started once the listener is
    bound: /readyz answers 503 "warming" until the engine is built and
    its programs captured, then 200, or "failed" if the build raised;
    server_close() joins that thread); the
    default "" means window iff batch_window_ms > 0, else none; window
    and continuous are gpt only. The metric history always samples the
    registry and the engine's counters (a tick thread every
    history_interval_s when > 0); alerts evaluates alert_rules (default
    serve_replica_rules at ttft_slo_s) against it; tenant_quotas turns on
    TenantQoS admission; enable_debug_endpoints serves /debug/profilez.
    A server_close() stops their threads. device: `cuda` unless named;
    the model is moved there. kv_quant_int8, weights_int8 (the model
    quantized once here unless it already is the int8 twin, which turns
    the flag on by itself), speculative, speculate/spec_depth/draft_preset,
    role ("", "prefill" or "decode"; advertised on /healthz and /kv/digest)
    and their combinations are the reference's, refused in its words
    (ValueError). An MoE LM with any gpt-family option raises ValueError,
    as the reference.

    mesh_shape ((batch, model) or "BxM"; continuous batching, paged
    layout): the engine's sharded step over a mesh of `mesh_devices`
    (serve/engine.py). mesh (parallel/mesh.py build_mesh's, called on
    every rank of a tensor-parallel world): inline decode through
    generate(mesh=), the model laid out by TRANSFORMER_RULES once here
    (int8 weights quantized whole first); rank 0 gets the server, every
    other rank a MeshFollower (see the module docstring)."""
    from .._device import resolve_device
    from ..ops.quant import is_quantized, quantize_model

    if _family(model) == "moe" and (
        kv_quant_int8 or weights_int8 or speculative or speculate != "off"
        or batch_window_ms > 0 or mesh is not None or mesh_shape is not None
        or batching not in ("", "none")
    ):
        raise ValueError(_MOE_STARTUP)
    if role and role not in ("prefill", "decode"):
        raise ValueError(f"role must be '', 'prefill' or 'decode', got {role!r}")
    if not batching:
        batching = "window" if batch_window_ms > 0 else "none"
    if batching not in ("none", "window", "continuous"):
        raise ValueError(f"batching must be none/window/continuous, got {batching!r}")
    if batching == "window" and batch_window_ms <= 0:
        raise ValueError(
            "batching='window' needs batch_window_ms > 0 (the coalesce window IS the "
            "policy knob)"
        )
    if batching == "continuous" and batch_window_ms > 0:
        raise ValueError(
            "batching='continuous' and batch_window_ms are mutually exclusive: the engine "
            "admits per step, there is no coalesce window"
        )
    if warm_async and batching != "continuous":
        raise ValueError(
            "warm_async requires batching='continuous': only the engine has a "
            "construction-time compile worth overlapping with the listener boot"
        )
    if batching == "continuous" and speculative:
        raise ValueError(
            "batching='continuous' and speculative are mutually exclusive: the engine owns "
            "the greedy path and its quantum is one token, not a drafted run"
        )
    if batching == "continuous" and mesh is not None:
        raise ValueError(
            "batching='continuous' and mesh are mutually exclusive: the generate(mesh=) "
            "path belongs to inline decode; the engine shards through mesh_shape instead "
            "(ShardedPagedSlotDecodeStep)"
        )
    if mesh_shape is not None:
        if batching != "continuous":
            raise ValueError(
                "mesh_shape requires batching='continuous': only the slot engine compiles "
                "the sharded decode step"
            )
        if kv_layout != "paged":
            raise ValueError(
                "mesh_shape requires kv_layout='paged': the sharded step partitions the "
                "paged block pool"
            )
    if speculative and mesh is not None:
        raise ValueError(
            "speculative and mesh are mutually exclusive: the speculative verify loop is a "
            "single-device program; sharded serving uses the plain generate(mesh=) path"
        )
    if speculative and batch_window_ms > 0:
        raise ValueError(
            "speculative and batch_window_ms are mutually exclusive: the dynamic batcher's "
            "shape bucketing (padded widths, dummy rows) defeats the uniform-length "
            "speculative gate; pick the one that fits the traffic"
        )
    if speculate not in ("off", "ngram", "draft"):
        raise ValueError(f"speculate must be 'off', 'ngram' or 'draft', got {speculate!r}")
    if speculate != "off":
        if batching != "continuous":
            raise ValueError(
                "speculate requires batching='continuous' (the engine owns the draft/verify "
                "loop; the inline prompt-lookup path is the `speculative` flag)"
            )
        if kv_layout != "paged":
            raise ValueError(
                "speculate requires kv_layout='paged' (the verify program scores windows "
                "against the block pool)"
            )
        if role == "prefill":
            raise ValueError(
                "speculate is decode-pool-only: a prefill replica never decodes, so its "
                "draft/verify programs would be dead compiles"
            )
    draft_model = None
    if speculate == "draft":
        presets = _draft_presets()
        draft_cfg = presets.get(draft_preset or "draft-tiny")
        if draft_cfg is None:
            raise ValueError(f"unknown draft preset {draft_preset!r} (have: {sorted(presets)})")
    device = resolve_device(device)
    model.to(device)
    if _family(model) == "gpt":
        if is_quantized(model) and not weights_int8:
            logger.info("the model is the int8 twin: enabling weights_int8")
            weights_int8 = True
        if weights_int8:
            # one quantization at load; every decode then reads the int8
            # twin (the caller drops the f32 model to free its kernels).
            # Under a mesh the whole model is quantized before it is laid
            # out, so a row-parallel kernel's scales are the whole kernel's
            model = quantize_model(model)
        if mesh is not None and mesh.shape["tp"] > 1 and \
                getattr(model, "tensor_parallel", None) is None:
            # laid out once here, not inside every request's decode
            import copy

            from ..parallel import sharding

            model = sharding.apply_tensor_parallel(copy.deepcopy(model), mesh,
                                                   sharding.TRANSFORMER_RULES)
    state = _State(model, model_name, max_new_cap, device, kv_quant_int8=kv_quant_int8,
                   weights_int8=weights_int8, speculative=speculative, role=role)
    if mesh is not None:
        from ..parallel import distributed

        if distributed.is_initialized() and distributed.rank() != 0:
            return MeshFollower(state)
        state.mesh = mesh
    state.enable_debug = bool(enable_debug_endpoints)
    # the metric history: every registry family plus the engine's flat
    # counters, read at each tick (the provider reads state.engine then)
    from ..telemetry import AlertManager, MetricHistory, serve_replica_rules

    state.history = MetricHistory(capacity=history_capacity)
    state.history.track_registry(state.registry)
    state.history.track_flat(lambda: state.engine.metrics() if state.engine is not None else {})
    if alerts:
        state.alerts = AlertManager(
            state.history,
            alert_rules if alert_rules is not None else serve_replica_rules(
                prefix="tf_operator_tpu_serve", ttft_slo_s=ttft_slo_s),
            registry=state.registry, flight=default_flight(),
        )
    if tenant_quotas is not None:
        # the queue-wait projection reads the same history the alert
        # rules read
        state.qos = TenantQoS(tenant_quotas, ttft_slo_s=ttft_slo_s, history=state.history,
                              registry=state.registry)
    if batching == "window":
        from .batching import DynamicBatcher

        def decode_fn(prompt, lens, new):
            # the columns past the longest row are padding that no row
            # reads: without them a group whose rows share one length (a
            # lone request) takes generate's prefill path, not the ragged
            # path's one step a prompt position
            return _device_decode(state, prompt[:, :max(lens)], lens, new)

        state.batcher = DynamicBatcher(state, decode_fn, window_ms=batch_window_ms,
                                       max_batch=MAX_BATCH, max_seq_len=_max_seq(model.cfg))
    elif batching == "continuous":
        import torch

        from ..models import gpt as gpt_lib
        from .engine import ContinuousBatchingEngine

        if speculate == "draft":
            # random weights from seed 0: every replica drafts alike
            draft_model = gpt_lib.GPT(draft_cfg, generator=torch.Generator().manual_seed(0))
        def build_engine():
            # the programs are captured on the engine's own thread, which
            # the constructor starts and waits for
            state.engine = ContinuousBatchingEngine(
                model, n_slots=n_slots, registry=state.registry, tracer=state.tracer,
                kv_layout=kv_layout, block_size=block_size, kv_blocks=kv_blocks,
                prefill_chunk=prefill_chunk, device=device, kv_quant_int8=kv_quant_int8,
                weights_int8=weights_int8, speculate=speculate, spec_depth=spec_depth,
                draft_model=draft_model, role=role, mesh_shape=mesh_shape,
                mesh_devices=mesh_devices,
            )

        if warm_async:
            def warm():
                try:
                    build_engine()
                except Exception:  # noqa: BLE001 — a dead warm-up must show
                    # on /readyz, not leave pollers at "warming" for ever
                    logger.exception("async engine warm-up failed")
                    state.phase = "failed"
                    return
                state.ready_at = time.monotonic()
                state.phase = "ready"

            state.warmup_thread = threading.Thread(target=warm, name="engine-warmup",
                                                   daemon=True)
        else:
            build_engine()
    server = DecodeHTTPServer((host, port), DecodeHandlerFactory(state))
    server.state = state
    if history_interval_s > 0:
        # the alert manager ticks the history before each evaluation
        (state.alerts or state.history).start(history_interval_s)
    if state.warmup_thread is not None:
        # the listener exists: /readyz answers "warming" while the engine
        # builds; the phase flips inside the thread
        state.warmup_thread.start()
    else:
        state.ready_at = time.monotonic()
        state.phase = "ready"
    return server


def _draft_presets():
    """The named draft configs of --speculate draft: 'draft-tiny' (the
    default, GPT_DRAFT) and 'tiny', both sharing GPT_TINY's vocabulary."""
    from ..models import gpt as gpt_lib

    return {"draft-tiny": gpt_lib.GPT_DRAFT, "tiny": gpt_lib.GPT_TINY}


# CLI flags of the reference's server that the port refuses, with why
_REFUSED_FLAGS = (
    ("--warm", True, "--warm pre-compiles jit shapes; the port has none to compile"),
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m tf_operator_tpu_torch.serve")
    parser.add_argument(
        "--preset", choices=["tiny", "small", "moe-tiny", "moe-base"], default="small",
        help="gpt presets (tiny/small); the moe presets serve plain greedy/sampled "
        "decode (models/moe.py moe_generate)",
    )
    parser.add_argument("--port", type=int, default=None,
                        help="default $PORT, else 8600")
    parser.add_argument(
        "--host", default="0.0.0.0",
        help="bind address (default 0.0.0.0: pods must answer on the pod IP)",
    )
    parser.add_argument("--checkpoint-dir", default=None,
                        help="serve the newest step the port's training CLIs wrote here")
    parser.add_argument("--device", default=None, help="default cuda; cpu for the CPU")
    parser.add_argument("--max-new-cap", type=int, default=1024,
                        help="upper bound a single request may ask for")
    parser.add_argument(
        "--batch-window-ms", type=float, default=0.0,
        help="window batching: hold a greedy request this long to coalesce concurrent "
        "peers into one decode (0 = off; implies --batching window)",
    )
    parser.add_argument(
        "--batching", choices=["none", "window", "continuous"], default="",
        help="greedy scheduling: none (inline, serialized), window (serve/batching.py; "
        "needs --batch-window-ms) or continuous (the slot engine: per-step admit/evict, "
        "token streaming, one capture per program). Default: window iff "
        "--batch-window-ms > 0, else none",
    )
    parser.add_argument("--slots", type=int, default=8,
                        help="slot-grid rows for --batching continuous")
    parser.add_argument("--kv-layout", choices=["paged", "dense"], default="paged",
                        help="KV layout for --batching continuous")
    parser.add_argument("--block-size", type=int, default=64,
                        help="tokens per KV block under --kv-layout paged")
    parser.add_argument(
        "--kv-blocks", type=int, default=0,
        help="usable blocks in the paged pool (0 = slots x max_seq_len / block_size)",
    )
    parser.add_argument("--prefill-chunk", type=int, default=64,
                        help="chunked-prefill width under --kv-layout paged (0 = off)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV cache (per-(position, head) scales)")
    parser.add_argument(
        "--weights-int8", action="store_true",
        help="int8 kernels (ops/quant.py): the model quantized once at load",
    )
    parser.add_argument(
        "--speculative", action="store_true",
        help="prompt-lookup speculative decoding for single-row uniform-length inline "
        "requests (token-exact for greedy at f32)",
    )
    parser.add_argument(
        "--speculate", choices=["off", "ngram", "draft"], default="off",
        help="speculative decoding in the continuous-batching engine (needs --batching "
        "continuous --kv-layout paged): 'ngram' drafts from a host-side prompt lookup, "
        "'draft' from a small draft model (--draft-preset)",
    )
    parser.add_argument(
        "--draft-preset", default="",
        help="draft config for --speculate draft (default draft-tiny, GPT_TINY's "
        "vocabulary)",
    )
    parser.add_argument(
        "--spec-depth", type=int, default=4,
        help="most tokens drafted per speculative round; the verify scores K+1",
    )
    parser.add_argument(
        "--mesh-shape", default="", metavar="BATCHxMODEL",
        help="('batch','model') mesh for the sharded continuous-batching decode step, "
        "e.g. 1x2: attention heads and the paged KV pool split on the model axis, slot "
        "rows on the batch axis (models/gpt.py ShardedPagedSlotDecodeStep). Requires "
        "--batching continuous and --kv-layout paged; a host with fewer devices than the "
        "shape puts several shards on one device",
    )
    parser.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel degree for inline decode: a world of one process a rank "
        "(formed from the operator's environment, as the training CLIs' --tp), the "
        "weights laid out by TRANSFORMER_RULES and each decode made by every rank "
        "(generate(mesh=)); rank 0 serves HTTP. Mutually exclusive with --speculative "
        "and --batching continuous",
    )
    parser.add_argument(
        "--role", choices=["", "prefill", "decode"], default="",
        help="disaggregated serving role advertised on /healthz and /kv/digest: prefill "
        "replicas take the prefix-ingest half of the workload (POST /prefill + KV "
        "block-set export), decode replicas admit migrated block sets (POST /kv/import) "
        "and serve the token streams. Default '': monolithic, both halves in one engine",
    )
    parser.add_argument(
        "--enable-debug-endpoints", action="store_true",
        help="serve GET /debug/profilez (the sampling profiler: start/stop/snapshot, "
        "folded or speedscope output). Off by default: live thread stacks are sensitive",
    )
    parser.add_argument(
        "--history-interval", type=float, default=5.0,
        help="seconds between metric-history samples: every registry family and engine "
        "counter is ring-buffered for /debug/historyz and the alert rules (0 disables the "
        "background cadence)",
    )
    parser.add_argument(
        "--history-capacity", type=int, default=512,
        help="samples kept per history series (512 at the default 5 s cadence is ~42 "
        "minutes)",
    )
    parser.add_argument(
        "--alerts", choices=["on", "off"], default="on",
        help="evaluate the serve alert rules (TTFT burn rate, queue depth, KV occupancy, "
        "pool-audit failures) against the history each sample; states at /debug/alertz, "
        "transitions flight-recorded kind=alert",
    )
    parser.add_argument(
        "--ttft-slo-ms", type=float, default=250.0,
        help="the TTFT objective the burn-rate rule guards (95%% of first tokens under "
        "this; it must sit on a TTFT bucket edge)",
    )
    parser.add_argument(
        "--tenant-quotas", default="", metavar="JSON",
        help="per-tenant QoS admission, e.g. '{\"noisy\": {\"rate\": 100, \"burst\": "
        "200, \"priority\": \"batch\"}, \"*\": {\"priority\": \"standard\"}}': "
        "token-bucket rate/burst in generated tokens, priority class high/standard/batch "
        "('*' = the default for unnamed tenants), the tenant from the X-Tenant header; "
        "over-budget or queue-pressured requests get 429 + Retry-After. Empty = QoS off",
    )
    parser.add_argument(
        "--smoke", action="store_true",
        help="self-contained telemetry smoke: boot GPT_TINY behind a continuous-batching "
        "server on --device, drive two requests, validate the /metrics exposition, a "
        "complete /debug/trace span and the /debug/flightz records, print a JSON report, "
        "exit 0/1; all other flags but --device are ignored",
    )
    for flag, takes_value, _ in _REFUSED_FLAGS:
        if takes_value:
            parser.add_argument(flag, default=None, help=argparse.SUPPRESS)
        else:
            parser.add_argument(flag, action="store_true", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.preset.startswith("moe"):
        offending = [
            flag for flag, on in (
                ("--kv-int8", args.kv_int8), ("--weights-int8", args.weights_int8),
                ("--speculative", args.speculative),
                ("--speculate", args.speculate not in (None, "off")),
                ("--batch-window-ms", args.batch_window_ms > 0),
                ("--batching", args.batching not in ("", "none")),
                ("--tp", args.tp > 1), ("--mesh-shape", bool(args.mesh_shape)),
            ) if on
        ]
        if offending:
            parser.error(f"{', '.join(offending)} {_MOE_FLAGS}")
    if not args.batching:
        args.batching = "window" if args.batch_window_ms > 0 else "none"
    if args.batching == "window" and args.batch_window_ms <= 0:
        parser.error("--batching window needs --batch-window-ms > 0")
    if args.batching == "continuous":
        offending = [flag for flag, on in (("--batch-window-ms", args.batch_window_ms > 0),
                                           ("--speculative", args.speculative)) if on]
        if offending:
            parser.error(
                f"--batching continuous is mutually exclusive with {', '.join(offending)}"
            )
    if args.speculative and args.batch_window_ms > 0:
        parser.error("--speculative is mutually exclusive with --batch-window-ms")
    args.mesh_shape_parsed = None
    if args.mesh_shape:
        if args.batching != "continuous":
            parser.error("--mesh-shape requires --batching continuous")
        if args.kv_layout != "paged":
            parser.error("--mesh-shape requires --kv-layout paged")
        if args.weights_int8:
            parser.error(
                "--mesh-shape and --weights-int8 are mutually exclusive: the sharded step "
                "has no int8-kernel partition rules yet")
        from .engine import _parse_mesh_shape

        try:
            args.mesh_shape_parsed = _parse_mesh_shape(args.mesh_shape)
        except ValueError as exc:
            parser.error(str(exc))
    if args.tp < 1:
        parser.error("--tp must be >= 1")
    if args.tp > 1:
        offending = [flag for flag, on in (("--speculative", args.speculative),
                                           ("--batching continuous",
                                            args.batching == "continuous")) if on]
        if offending:
            parser.error(f"--tp is mutually exclusive with {', '.join(offending)}")
    if args.speculate != "off":
        if args.batching != "continuous":
            parser.error("--speculate requires --batching continuous")
        if args.kv_layout != "paged":
            parser.error("--speculate requires --kv-layout paged")
        if args.role == "prefill":
            parser.error("--speculate is decode-pool-only (a prefill replica never decodes)")
        if args.spec_depth < 1:
            parser.error("--spec-depth must be >= 1")
    if args.draft_preset and args.speculate != "draft":
        parser.error("--draft-preset requires --speculate draft")
    if args.draft_preset and args.draft_preset not in ("draft-tiny", "tiny"):
        parser.error(f"unknown --draft-preset {args.draft_preset!r} (have: draft-tiny, tiny)")
    for flag, _, why in _REFUSED_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag}: {why}")
    args.tenant_quotas_parsed = None
    if args.tenant_quotas:
        try:
            quotas = json.loads(args.tenant_quotas)
            if not isinstance(quotas, dict):
                raise ValueError("must be a JSON object")
            TenantQoS(quotas)  # field validation before any device work
        except ValueError as exc:
            parser.error(f"--tenant-quotas: {exc}")
        args.tenant_quotas_parsed = quotas
    if args.slots < 1:
        parser.error("--slots must be >= 1")
    if args.batching == "continuous" and args.kv_layout == "paged":
        from ..models.gpt import GPT_SMALL, GPT_TINY

        max_seq = (GPT_TINY if args.preset == "tiny" else GPT_SMALL).max_seq_len
        if args.block_size < 1 or max_seq % args.block_size:
            parser.error(
                f"--block-size {args.block_size} must be >= 1 and divide the preset's "
                f"max_seq_len {max_seq}"
            )
        if args.kv_blocks < 0:
            parser.error("--kv-blocks must be >= 0 (0 = auto)")
        if args.prefill_chunk < 0:
            parser.error("--prefill-chunk must be >= 0 (0 = off)")
    return args


def load_model(preset: str, checkpoint_dir: Optional[str], device):
    """The preset's model on `device` (a GPT, or an MoELM for the moe
    presets): a serve/export.py artifact in checkpoint_dir (the int8 twin,
    which make_server serves with weights_int8 on; an artifact of another
    preset is refused), else the newest checkpoint there (the port's
    Checkpointer format, as train/gpt.py and train/moe.py write it), else
    random weights from seed 0, said loudly."""
    import torch

    from ..models import gpt as gpt_lib
    from ..models import moe as moe_lib
    from . import export as export_mod

    if checkpoint_dir and export_mod.is_exported_dir(checkpoint_dir):
        model, manifest = export_mod.exported_model(checkpoint_dir, preset, device)
        logger.info(
            "serving exported step-%d artifact (%.1fMB params, quantized=%s)",
            manifest.get("step", -1), manifest.get("params_bytes", 0) / 1e6,
            manifest.get("quantized"),
        )
        return model

    generator = torch.Generator().manual_seed(0)
    if preset.startswith("moe"):
        cfg = {"moe-tiny": moe_lib.MOE_TINY, "moe-base": moe_lib.MOE_BASE}[preset]
        model = moe_lib.MoELM(cfg, generator=generator)
    else:
        cfg = gpt_lib.GPT_PRESETS[preset]
        model = gpt_lib.GPT(cfg, generator=generator)
    step = None
    if checkpoint_dir:
        from ..train.trainer import Checkpointer

        checkpointer = Checkpointer(checkpoint_dir)
        step = checkpointer.latest_step()
        if step is not None:
            payload = torch.load(checkpointer.path(step), map_location="cpu", weights_only=True)
            model.load_state_dict(payload["model"])
            logger.info("serving the step-%d checkpoint of %s", step, checkpoint_dir)
        else:
            logger.warning("no checkpoint in %s; serving RANDOM weights", checkpoint_dir)
    else:
        logger.warning("no --checkpoint-dir; serving RANDOM weights")
    return model.to(device)


def _smoke(device=None) -> int:
    """Telemetry smoke: boot GPT_TINY (random weights from seed 0) behind
    a continuous-batching server on `device` (cuda unless named), drive
    one streaming and one batch request, then assert the telemetry
    contract end to end: /metrics parses as exposition text with a
    nonzero TTFT histogram, /debug/trace holds >= 1 complete
    serve-request span carrying its queued/admitted/first-token marks,
    and /debug/flightz serves JSONL whose ?request= filter returns the
    streamed request's correlated submit/admit/evict records (the
    request_id echoed on its done event). The dump is round-tripped
    through `python -m tf_operator_tpu_torch.telemetry`. Prints a JSON
    report; -> 1 on any violated assertion."""
    import tempfile

    import torch

    from .._device import resolve_device
    from ..models import gpt as gpt_lib
    from ..telemetry import ExpositionError, validate_text
    from ..telemetry.__main__ import main as flight_cli
    from .client import DecodeClient

    device = resolve_device(device)
    model = gpt_lib.GPT(gpt_lib.GPT_TINY, generator=torch.Generator().manual_seed(0))
    server = make_server(
        model.to(device), port=0, model_name="gpt-tiny", batching="continuous", n_slots=4,
        device=device,
    )
    del model
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = DecodeClient(f"http://127.0.0.1:{server.server_address[1]}", timeout=120.0)
        streamed = 0
        stream_request_id = None
        for event in client.generate_stream([1, 2, 3], max_new_tokens=8):
            if "token" in event:
                streamed += 1
            if event.get("done"):
                stream_request_id = event.get("request_id")
        chains = client.generate([[5, 6], [7, 8, 9]], max_new_tokens=4)
        text = client.metrics_text()
        try:
            validate_text(text)
            exposition_error = None
        except ExpositionError as err:
            exposition_error = str(err)
        flat = client.metrics()
        ttft_count = int(flat.get("tf_operator_tpu_serve_ttft_seconds_count", 0))
        trace = client.trace()
        spans = [
            event for event in trace.get("traceEvents", [])
            if event.get("ph") == "X" and event.get("name") == "serve-request"
        ]
        marks = {
            event.get("name") for event in trace.get("traceEvents", [])
            if event.get("ph") == "i"
        }
        # the full dump parses, and the streamed request's id pulls its
        # own correlated slot records
        flight_all = client.flightz()
        flight_req = client.flightz(request=stream_request_id) if stream_request_id else []
        flight_ops = {r["fields"].get("op") for r in flight_req}
        span_corrs = {
            e.get("args", {}).get("corr") for e in trace["traceEvents"] if e.get("ph") == "X"
        }
        with tempfile.TemporaryDirectory() as tmp:
            dump_path = os.path.join(tmp, "flight.jsonl")
            with open(dump_path, "w") as f:
                f.write("\n".join(json.dumps(r) for r in flight_all) + "\n")
            cli_rc = flight_cli([dump_path, "--quiet", "--perfetto", dump_path + ".trace.json"])
    finally:
        server.shutdown()
        server.server_close()
        if server.state.engine is not None:
            server.state.engine.stop()
    report = {
        "streamed_tokens": streamed,
        "batch_chains": len(chains),
        "exposition_error": exposition_error,
        "ttft_count": ttft_count,
        "complete_spans": len(spans),
        "span_marks": sorted(m for m in marks if m),
        "stream_request_id": stream_request_id,
        "flight_records": len(flight_all),
        "flight_request_ops": sorted(o for o in flight_ops if o),
        "flight_cli_rc": cli_rc,
        "ok": (
            streamed == 8
            and len(chains) == 2
            and exposition_error is None
            and ttft_count >= 3  # 1 streamed + 2 batch rows
            and len(spans) >= 1
            and {"queued", "admitted", "first-token"} <= marks
            and stream_request_id is not None
            and len(flight_all) > 0
            # the streamed request's lifecycle, correlated end to end
            and {"request", "submit", "admit", "evict"} <= flight_ops
            # the trace's span args share the flight correlation id
            and stream_request_id in span_corrs
            and cli_rc == 0
        ),
    }
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    from .._device import resolve_device

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    if args.smoke:
        return _smoke(args.device)
    device = resolve_device(args.device)
    if args.tp > 1:
        from ..parallel import distributed

        with distributed.world(device):
            return _serve(args, device)
    return _serve(args, device)


def _serve(args, device) -> int:
    import signal

    mesh = mesh_devices = None
    if args.tp > 1:
        from ..parallel.mesh import MeshConfig, build_mesh, mesh_summary

        mesh = build_mesh(MeshConfig(dp=-1, tp=args.tp), device)
        logger.info("sharded decode over mesh %s", mesh_summary(mesh))
    if args.mesh_shape_parsed is not None:
        from ..parallel.mesh import short_host_devices

        batch, model_axis = args.mesh_shape_parsed
        mesh_devices = short_host_devices(device, batch * model_axis)
    model = load_model(args.preset, args.checkpoint_dir, device)
    port = args.port if args.port is not None else int(os.environ.get("PORT", "8600"))
    try:
        server = make_server(
            model, port=port, model_name=args.preset if args.preset.startswith("moe")
            else f"gpt-{args.preset}", max_new_cap=args.max_new_cap,
            host=args.host, batching=args.batching, n_slots=args.slots,
            kv_layout=args.kv_layout, block_size=args.block_size, kv_blocks=args.kv_blocks,
            prefill_chunk=args.prefill_chunk, device=device, kv_quant_int8=args.kv_int8,
            weights_int8=args.weights_int8, speculative=args.speculative,
            speculate=args.speculate, spec_depth=args.spec_depth,
            draft_preset=args.draft_preset, batch_window_ms=args.batch_window_ms,
            role=args.role, tenant_quotas=args.tenant_quotas_parsed,
            enable_debug_endpoints=args.enable_debug_endpoints,
            history_capacity=max(2, args.history_capacity),
            history_interval_s=max(0.0, args.history_interval),
            alerts=args.alerts == "on", ttft_slo_s=args.ttft_slo_ms / 1000.0,
            mesh=mesh, mesh_shape=args.mesh_shape_parsed, mesh_devices=mesh_devices,
        )
    except ValueError as err:
        # a combination only the model can judge (a draft whose vocabulary
        # is not the target's): refused before the listener exists
        logger.error("refused: %s", err)
        return 2
    del model
    if isinstance(server, MeshFollower):
        logger.info("mesh follower of rank 0's server (%s)", device)
        server.serve_forever()
        logger.info("rank 0 stopped; exiting 0")
        return 0
    logger.info("decode server on :%d (%s)", server.server_address[1], device)
    # graceful drain: SIGTERM stops accepting, lets in-flight requests
    # finish and exits 0. Non-daemon handler threads + block_on_close
    # make server_close() join whatever is still decoding.
    server.daemon_threads = False
    server.block_on_close = True

    def _drain(signum, frame):
        logger.info("signal %d: draining in-flight requests", signum)
        # flip the phase first: /readyz goes 503 and /healthz says
        # "draining" before the listener begins shutting down
        server.state.phase = "draining"
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    server.server_close()
    if server.state.engine is not None:
        server.state.engine.stop()  # fail any still-queued requests
    logger.info("drained; exiting 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
