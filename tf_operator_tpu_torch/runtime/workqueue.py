"""Rate-limited work queue with client-go semantics.

The reference's hot loop is driven by a client-go
RateLimitingInterface (reference jobcontroller.go:126-136, 189-194):
an item is never processed by two workers at once, re-adds during
processing coalesce into one redo, and per-item retries back off
exponentially. Those invariants are the controller's concurrency
model, so they're reproduced here exactly.

The reference also carries a C++ queue with the same interface
(native/); the port uses only this pure-Python one, which is the
reference's semantics and its fallback (TFOPRT_DISABLE_NATIVE=1).

The port's copy of tf_operator_tpu/runtime/workqueue.py; it imports nothing of that package.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Hashable, Optional, Set

from ..utils import locks


class ExponentialBackoff:
    """Per-item exponential failure backoff (client-go
    ItemExponentialFailureRateLimiter; defaults 5ms base, 1000s cap).

    With jitter=True the deterministic doubling becomes decorrelated
    jitter (next = uniform(base, 3*prev), capped): many keys failing on
    the same cause — an apiserver outage — spread their retries instead
    of thundering back in lockstep. Off by default because tier-1 tests
    rely on exact delay arithmetic.
    """

    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 1000.0,
        jitter: bool = False,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._failures: Dict[Hashable, int] = {}
        self._prev_delay: Dict[Hashable, float] = {}
        self._lock = locks.make_lock("ExponentialBackoff._lock")

    def when(self, item: Hashable) -> float:
        with self._lock:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
            if not self.jitter:
                return min(self.base_delay * (2**failures), self.max_delay)
            prev = self._prev_delay.get(item, self.base_delay)
            delay = min(
                self.max_delay, self._rng.uniform(self.base_delay, prev * 3)
            )
            self._prev_delay[item] = delay
            return delay

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)
            self._prev_delay.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class WorkQueue:
    """Deduplicating queue: invariants of client-go workqueue.Type.

    - An item added while queued is not duplicated.
    - An item added while being *processed* ("dirty while running") is
      re-queued when its worker calls done().
    - shut_down() drains: get() returns None once empty.

    metrics (optional) is a duck-typed hook object with the client-go
    workqueue convention surface — on_add(depth), on_get(queue_seconds,
    depth), on_done(work_seconds) — e.g. server/metrics.py
    WorkqueueMetrics. Timestamps are taken HERE, at the actual
    enqueue/dequeue transitions (so dedup'd adds don't reset the queue
    age and a dirty-while-running redo is aged from its re-queue).
    """

    def __init__(self, metrics=None) -> None:
        self._cond = locks.make_condition("WorkQueue._cond")
        self._queue: list = []
        self._dirty: Set[Hashable] = set()
        self._processing: Set[Hashable] = set()
        self._shutting_down = False
        self._metrics = metrics
        self._added_at: Dict[Hashable, float] = {}
        self._started_at: Dict[Hashable, float] = {}

    def add(self, item: Hashable) -> None:
        # metric hooks run AFTER the condition is released: they are
        # caller-supplied code and may take their own locks or call
        # back into this queue (graftlint: callback-under-lock)
        depth = None
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                if self._metrics is not None:
                    self._added_at.setdefault(item, time.monotonic())
                    depth = len(self._queue)
                self._cond.notify()
        if depth is not None:
            self._metrics.on_add(depth)

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Block for the next item; None on shutdown-and-drained or timeout."""
        got = None
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue:
                if self._shutting_down:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            if self._metrics is not None:
                now = time.monotonic()
                self._started_at[item] = now
                got = (now - self._added_at.pop(item, now), len(self._queue))
        if got is not None:
            self._metrics.on_get(*got)
        return item

    def done(self, item: Hashable) -> None:
        work_seconds = None
        depth = None
        with self._cond:
            self._processing.discard(item)
            if self._metrics is not None and item in self._started_at:
                work_seconds = time.monotonic() - self._started_at.pop(item)
            if item in self._dirty:
                self._queue.append(item)
                if self._metrics is not None:
                    self._added_at.setdefault(item, time.monotonic())
                    depth = len(self._queue)
                self._cond.notify()
        if work_seconds is not None:
            self._metrics.on_done(work_seconds)
        if depth is not None:
            self._metrics.on_add(depth)

    def shut_down(self) -> None:
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)


class DelayingQueue(WorkQueue):
    """WorkQueue plus add_after, via a background timer thread."""

    def __init__(self, metrics=None) -> None:
        super().__init__(metrics=metrics)
        self._timer_lock = locks.make_lock("DelayingQueue._timer_lock")
        self._timers: Set[threading.Timer] = set()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        timer: threading.Timer = threading.Timer(delay, lambda: self._fire(item, timer))
        timer.daemon = True
        # register AND start under _timer_lock, checking shutdown first:
        # otherwise an add_after racing shut_down can arm its timer
        # after the cancel sweep, leaving a live timer firing into a
        # drained queue (same lock order as shut_down: _timer_lock
        # before _cond)
        with self._timer_lock:
            with self._cond:
                if self._shutting_down:
                    return
            self._timers.add(timer)
            timer.start()

    def _fire(self, item: Hashable, timer: threading.Timer) -> None:
        with self._timer_lock:
            self._timers.discard(timer)
        self.add(item)

    def shut_down(self) -> None:
        with self._timer_lock:
            for timer in self._timers:
                timer.cancel()
            self._timers.clear()
        super().shut_down()


class RateLimitingQueue(DelayingQueue):
    """DelayingQueue plus per-item exponential retry accounting
    (client-go RateLimitingInterface: AddRateLimited/Forget/NumRequeues)."""

    def __init__(
        self,
        backoff: Optional[ExponentialBackoff] = None,
        metrics=None,
    ) -> None:
        super().__init__(metrics=metrics)
        self._backoff = backoff or ExponentialBackoff()

    def add_rate_limited(self, item: Hashable) -> None:
        if self._metrics is not None:
            self._metrics.on_retry()
        self.add_after(item, self._backoff.when(item))

    def forget(self, item: Hashable) -> None:
        self._backoff.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self._backoff.num_requeues(item)
