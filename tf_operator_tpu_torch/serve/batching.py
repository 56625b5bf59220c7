"""Window batching: the port's copy of tf_operator_tpu/serve/batching.py.
Concurrent decode requests coalesce into one `generate` call.

Decode is per batch nearly flat on a card (the cache read and the
one-token GEMMs are bandwidth-bound; rows ride along), so N concurrent
single-prompt requests decoded one by one waste the card. The batcher
holds the first request for a short window, drains compatible peers, pads
them into one ragged batch (generate's prompt_lens guarantees that pad
rows and pad columns are never read) and fans the chains back out.

Greedy requests only (temperature 0, no filters): sampled requests would
share one generator stream when batched, changing per-request
reproducibility, so they keep the inline path. Groups also key on
max_new_tokens (one decode length per call).

Shapes: batch sizes round up to BATCH_BUCKETS (pad rows: length-1 dummy
prompts) and prompt widths to WIDTH_BUCKET multiples, the reference's
buckets, so the port forms the reference's batches. The reference
bounds its compile universe with them; here they bound the set of GEMM
shapes the card sees.

The batcher's quantum is the whole decode: every request of a group
rides the full max_new_tokens, and a late arrival waits out the previous
group. The continuous-batching engine (serve/engine.py) shrinks the
quantum to one token; this batcher is the fallback where the engine does
not reach (beside speculative decoding, which the engine refuses) and
the simpler baseline.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
WIDTH_BUCKET = 16


class _Pending:
    __slots__ = (
        "prompt", "lens", "new", "event", "tokens", "error", "cancelled",
    )

    def __init__(self, prompt, lens, new):
        self.prompt = prompt  # np [rows, width]
        self.lens = lens      # list[int]
        self.new = new
        self.event = threading.Event()
        self.tokens = None
        self.error = None
        self.cancelled = False  # timed-out client: don't decode for it


class DynamicBatcher:
    """decode_fn(prompt [b, w] np.int32, lens list[int], new) ->
    np [b, w + new] greedy chains; the batcher owns grouping, padding,
    and fan-out. One background thread; submit() blocks the request
    thread until its rows are decoded."""

    def __init__(
        self,
        state,
        decode_fn,
        window_ms: float = 5.0,
        max_batch: int = 64,
        max_seq_len: int = 2048,
    ):
        self.state = state
        self.decode_fn = decode_fn
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name="decode-batcher", daemon=True
        )
        self.thread.start()

    def submit(self, prompt, lens, new, timeout: float = 600.0):
        """-> list of per-row token lists (row's prompt + new tokens);
        raises the group's decode error, or TimeoutError. A timed-out
        item is tombstoned so the batcher won't burn a device decode
        for a client that already got its 503."""
        if self._stop.is_set() or not self.thread.is_alive():
            raise RuntimeError("batcher is stopped")
        item = _Pending(np.asarray(prompt, np.int32), list(lens), int(new))
        self.queue.put(item)
        if not item.event.wait(timeout):
            item.cancelled = True
            raise TimeoutError("decode timed out in the batcher")
        if item.error is not None:
            raise item.error
        return item.tokens

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=5)

    # -- internals ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first.cancelled:
                continue
            group = []
            try:
                # drain INSIDE the try: an exception anywhere must fan
                # out instead of silently killing the batcher thread
                # (a dead batcher would hang every later request)
                group = self._drain_window(first)
                if not group:  # everyone cancelled during the window
                    continue
                self._decode_group(group)
            except Exception as err:  # noqa: BLE001 — fan the error out
                for item in group or [first]:
                    item.error = err
                    item.event.set()

    def _drain_window(self, first: _Pending):
        """Hold `first` for the window, absorbing compatible requests
        (same max_new_tokens, fits the batch cap); an incompatible one
        is re-queued for the next round."""
        group = [first]
        rows = first.prompt.shape[0]
        deadline = time.monotonic() + self.window
        while rows < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item.cancelled:
                continue
            if (
                item.new != first.new
                or rows + item.prompt.shape[0] > self.max_batch
            ):
                self.queue.put(item)
                break
            group.append(item)
            rows += item.prompt.shape[0]
        return [item for item in group if not item.cancelled]

    def _decode_group(self, group) -> None:
        new = group[0].new
        rows = sum(item.prompt.shape[0] for item in group)
        width = max(item.prompt.shape[1] for item in group)
        # bucket shapes so the set of decode shapes stays bounded; the
        # width bucket must still honor the per-request max_seq check
        width_b = min(
            -(-width // WIDTH_BUCKET) * WIDTH_BUCKET,
            self.max_seq_len - new,
        )
        width_b = max(width_b, width)
        batch_b = next(b for b in BATCH_BUCKETS if b >= rows)

        prompt = np.zeros((batch_b, width_b), np.int32)
        lens = np.ones((batch_b,), np.int32)  # dummy rows: 1-token prompt
        spans = []
        cursor = 0
        for item in group:
            n, w = item.prompt.shape
            prompt[cursor:cursor + n, :w] = item.prompt
            lens[cursor:cursor + n] = item.lens
            spans.append((item, cursor, n))
            cursor += n

        chains = np.asarray(self.decode_fn(prompt, lens.tolist(), new))
        for item, start, n in spans:
            item.tokens = [
                chains[start + i, : item.lens[i] + new].tolist()
                for i in range(n)
            ]
            item.event.set()
