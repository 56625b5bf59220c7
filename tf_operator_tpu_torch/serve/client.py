"""Client for the decode server: the port's copy of
tf_operator_tpu/serve/client.py (`DecodeClient`: generate,
generate_stream, beam_search, the KV block-set migration calls prefill,
kv_export, kv_import, kv_digest and kv_statz, healthy, ready, metrics,
metrics_text, trace, and the debug pages the fleet's observatory and
collector read: clockz, flightz, profilez, historyz and alertz; and
`DecodeError`).

    from tf_operator_tpu_torch.serve import DecodeClient

    client = DecodeClient("http://127.0.0.1:8600")
    chains = client.generate([[1, 2, 3], [7, 8]], max_new_tokens=16)
    client.prefill(prompt, migrate_to="http://127.0.0.1:8601")
    client.healthy()      # -> dict from /healthz
    client.metrics()      # -> {"tf_operator_tpu_serve_decodes_total": ...}

Stdlib-only (urllib); ragged prompt batches are the server's job to pad.
Transient failures (connection reset, 429/502/503) are replayed with the
decorrelated-jitter retry (runtime/retry.py), honoring a server
Retry-After hint. Whole-request POSTs replay freely; for
/generate_stream only the connect is retried: once the first byte of the
body has arrived, a failure propagates (replaying a half-consumed stream
would double tokens). A QoS 429 on /generate_stream is a typed terminal
event, as the reference's.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from ..runtime.retry import RETRY_AFTER_CAP, RetryPolicy, call_with_retries, retry_after_hint
from ..telemetry.tracecontext import trace_headers

# 500/504 are deliberately absent (unlike the substrate's transport
# policy): a 500 from the decode server is "this decode failed", which
# a blind replay re-pays a full decode for — the caller or router
# decides, not the transport.
RETRYABLE_DECODE_STATUSES = frozenset({429, 502, 503})

# request header naming the tenant for QoS admission; the server's
# TENANT_HEADER (serve/server.py)
TENANT_HEADER = "X-Tenant"


def _is_retryable(err: BaseException) -> bool:
    if isinstance(err, urllib.error.HTTPError):
        return err.code in RETRYABLE_DECODE_STATUSES
    # URLError without .code covers refused/reset/DNS
    return isinstance(
        err, (ConnectionError, TimeoutError, urllib.error.URLError)
    )


class DecodeError(RuntimeError):
    """A 4xx/5xx from the server, carrying its error message."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"{status}: {message}")
        self.status = status


def _to_decode_error(err: urllib.error.HTTPError) -> DecodeError:
    body = err.read().decode(errors="replace")
    try:
        message = json.loads(body).get("error", body)
    except json.JSONDecodeError:
        message = body
    return DecodeError(err.code, message)


class DecodeClient:
    def __init__(
        self,
        base_url: str,
        timeout: float = 300.0,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # RetryPolicy(max_attempts=1) disables retries (the router
        # supplies its own failover and wants failures fast)
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=1.0
        )
        # the fleet trace id of the most recent completed stream (the
        # server echoes it in the done event), so a caller can join
        # its request to /debug/tracez without parsing events itself
        self.last_trace_id: Optional[str] = None

    def _open(self, req: urllib.request.Request, op: str):
        """urlopen with transient-failure retries; the caller owns the
        returned response object. Safe to replay: no body bytes have
        been consumed until this returns."""
        return call_with_retries(
            urllib.request.urlopen,
            req,
            timeout=self.timeout,
            policy=self.retry_policy,
            classify=_is_retryable,
            retry_after=retry_after_hint,
            op=op,
        )

    def _request(
        self,
        path: str,
        payload: Optional[dict] = None,
        tenant: Optional[str] = None,
    ):
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers[TENANT_HEADER] = tenant
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers=trace_headers(headers),
            method="POST" if data is not None else "GET",
        )
        try:
            with self._open(req, f"decode{path.partition('?')[0]}") as resp:
                return resp.read()
        except urllib.error.HTTPError as err:
            raise _to_decode_error(err) from None

    def generate(
        self,
        input_ids: List[List[int]],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        tenant: Optional[str] = None,
    ) -> List[List[int]]:
        """Each row's full chain: its own prompt + max_new_tokens."""
        body = json.loads(self._request("/generate", {
            "input_ids": input_ids,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "seed": seed,
        }, tenant=tenant))
        return body["tokens"]

    def generate_stream(
        self,
        input_ids: List[int],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        tenant: Optional[str] = None,
    ):
        """Yield one event dict per line of the chunked ndjson
        /generate_stream response for ONE prompt row: {"token": t,
        "index": i} per generated token as the server produces it
        (incremental only with --batching continuous), then a final
        {"done": true, "tokens": [[...]], "prompt_lens": [n]}.
        urllib de-chunks transparently; a server-side decode failure
        mid-stream arrives as an {"error": ...} line and raises
        DecodeError here. Retries cover the connect only — past the
        first byte a failure propagates (a stream body is not
        idempotent; the router owns mid-stream failover).

        A QoS early-reject (HTTP 429 from tenant admission, after the
        connect retries give up) is not an error: it yields exactly one
        terminal event {"rejected": true, "status": 429, "retry_after":
        <the server's Retry-After, capped at RETRY_AFTER_CAP>, "error":
        <server message>}, so callers can back off without matching a
        stream exception's text.

        NOT a generator function: the request is built and connected
        HERE, so an ambient trace context (telemetry trace_scope) at
        the call site lands in the outbound traceparent header. A
        generator body would run in its consumer's context (PEP 567)
        and silently drop the binding the router set up."""
        data = json.dumps({
            "input_ids": [list(input_ids)],
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "seed": seed,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers[TENANT_HEADER] = tenant
        req = urllib.request.Request(
            self.base_url + "/generate_stream",
            data=data,
            headers=trace_headers(headers),
            method="POST",
        )
        try:
            resp = self._open(req, "decode/generate_stream")
        except urllib.error.HTTPError as err:
            if err.code == 429:
                hint = retry_after_hint(err)
                return iter(({
                    "rejected": True,
                    "status": 429,
                    "retry_after": min(RETRY_AFTER_CAP, hint if hint is not None else 1.0),
                    "error": str(_to_decode_error(err)),
                },))
            raise _to_decode_error(err) from None

        def events():
            with resp:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    if "error" in event:
                        raise DecodeError(200, event["error"])
                    if event.get("done") and event.get("trace_id"):
                        self.last_trace_id = event["trace_id"]
                    yield event

        return events()

    def beam_search(
        self,
        input_ids: List[List[int]],
        max_new_tokens: int = 16,
        num_beams: int = 4,
    ):
        """(beams, beam_scores) per row, best-first — uniform-length
        prompts only (the server enforces it)."""
        body = json.loads(self._request("/generate", {
            "input_ids": input_ids,
            "max_new_tokens": max_new_tokens,
            "num_beams": num_beams,
        }))
        return body["beams"], body["beam_scores"]

    # -- disaggregated prefill/decode (KV block-set migration) ---------

    def prefill(self, input_ids: List[int], migrate_to: Optional[str] = None) -> dict:
        """Run chunked prefill for ONE prompt row on this (prefill)
        replica and, when migrate_to names a decode replica's base URL,
        ship the resulting KV block set there. Returns the server's
        {"blocks": n, "migrated": bool, "imported": n} report (plus
        "error" when the ship failed; the blocks stay cached on the
        prefill replica either way)."""
        body: dict = {"input_ids": [list(input_ids)], "max_new_tokens": 1}
        if migrate_to:
            body["migrate_to"] = migrate_to
        return json.loads(self._request("/prefill", body))

    def kv_export(self, input_ids: List[int]) -> dict:
        """This prompt's cached full-block prefix K/V as a JSON-able
        block set: {"payload": <block set>|None, "blocks": n}."""
        return json.loads(self._request("/kv/export", {"input_ids": [list(input_ids)]}))

    def kv_import(self, payload: dict) -> dict:
        """Admit an exported block set into this replica's prefix cache;
        -> {"imported": total cached prefix blocks}."""
        return json.loads(self._request("/kv/import", payload))

    def kv_digest(self) -> dict:
        """The replica's rolling prefix digest: {"role", "block_size",
        "digest": [hash, ...]}, hashes most recently used first
        (serve/prefix.py's prefix_hash vocabulary)."""
        return json.loads(self._request("/kv/digest"))

    def kv_statz(self, top: int = 10) -> dict:
        """The replica's KV residency page from /kv/statz (paged engines;
        other replicas answer {"paged": False})."""
        return json.loads(self._request(f"/kv/statz?top={int(top)}"))

    def healthy(self) -> dict:
        return json.loads(self._request("/healthz"))

    def ready(self) -> bool:
        """True iff /readyz answers 200 (engine warm, not draining).
        Deliberately un-retried: a health probe must be cheap and
        honest, and its caller (the router) polls anyway."""
        # trace-exempt: a liveness probe belongs to no request trace
        req = urllib.request.Request(
            self.base_url + "/readyz", method="GET"
        )
        try:
            with urllib.request.urlopen(
                req, timeout=min(self.timeout, 5.0)
            ) as resp:
                return resp.status == 200
        except (OSError, urllib.error.URLError):
            return False

    def metrics(self) -> Dict[str, float]:
        """Flat {sample_name_with_labels: value}; histogram families
        appear as their `_bucket{le=...}`/`_sum`/`_count` samples
        (telemetry/exposition.py bucket_pairs/quantile_from_flat
        consume them)."""
        out = {}
        for line in self.metrics_text().splitlines():
            if line and not line.startswith("#"):
                name, value = line.split()
                out[name] = float(value)
        return out

    def metrics_text(self) -> str:
        """The raw /metrics exposition page (what metrics() parses) —
        feed it to telemetry.validate_text for a conformance check."""
        return self._request("/metrics").decode()

    def trace(self) -> dict:
        """Chrome/Perfetto trace-event JSON from /debug/trace: recent
        request spans (queued -> admitted -> first-token -> finished);
        load it in ui.perfetto.dev as-is."""
        return json.loads(self._request("/debug/trace"))

    def clockz(self) -> dict:
        """The replica's clock handshake from /debug/clockz:
        {"mono", "perf", "wall", "tracer_epoch_perf", "pid"} — the
        collector (telemetry/collector.py) samples it a few times,
        keeps the min-RTT sample, and maps each replica's monotonic
        timestamps onto its own clock."""
        return json.loads(self._request("/debug/clockz"))

    def flightz(
        self,
        request: Optional[str] = None,
        kind: Optional[str] = None,
        limit: Optional[int] = None,
        since: Optional[float] = None,
        trace: Optional[str] = None,
    ) -> List[dict]:
        """Parsed flight-recorder records from /debug/flightz, newest
        last. request filters on the correlation ID the server echoes
        as "request_id" (so a client can pull exactly its own
        admit/evict/step records); kind/limit/since/trace filter
        server-side (since = unix timestamp, records at or after it —
        pass a profile payload's wall_start to fetch the overlapping
        flight window; trace = fleet trace id, the collector's key)."""
        from urllib.parse import urlencode

        params = {}
        if request is not None:
            params["request"] = request
        if kind is not None:
            params["kind"] = kind
        if limit is not None:
            params["limit"] = str(limit)
        if since is not None:
            params["since"] = repr(float(since))
        if trace is not None:
            params["trace"] = trace
        path = "/debug/flightz"
        if params:
            path += "?" + urlencode(params)
        raw = self._request(path).decode()
        return [json.loads(line) for line in raw.splitlines() if line]

    def profilez(
        self,
        seconds: Optional[float] = None,
        hz: Optional[int] = None,
        format: str = "json",
    ):
        """Sampling-profiler snapshot from /debug/profilez (requires
        the server's --enable-debug-endpoints). format="json" returns
        the parsed to_json() payload; "folded"/"speedscope" return the
        raw bytes. seconds triggers a blocking capture window when the
        remote profiler isn't already running."""
        from urllib.parse import urlencode

        params = {"action": "snapshot", "format": format}
        if seconds is not None:
            params["seconds"] = repr(float(seconds))
        if hz is not None:
            params["hz"] = str(int(hz))
        raw = self._request("/debug/profilez?" + urlencode(params))
        return json.loads(raw) if format == "json" else raw

    def historyz(
        self,
        series: Optional[str] = None,
        window: Optional[float] = None,
        q: Optional[float] = None,
        points: bool = False,
    ) -> dict:
        """The replica's metric-history page from /debug/historyz
        (telemetry/history.py): per-series windowed summaries, plus
        raw sample points when points=True and a series filter is
        given."""
        from urllib.parse import urlencode

        params = {}
        if series is not None:
            params["series"] = series
        if window is not None:
            params["window"] = repr(float(window))
        if q is not None:
            params["q"] = repr(float(q))
        if points:
            params["points"] = "1"
        path = "/debug/historyz"
        if params:
            path += "?" + urlencode(params)
        return json.loads(self._request(path))

    def alertz(self, firing: bool = False) -> dict:
        """The replica's alert states from /debug/alertz
        (telemetry/alerts.py): rules, instances, firing list."""
        path = "/debug/alertz"
        if firing:
            path += "?firing=1"
        return json.loads(self._request(path))
