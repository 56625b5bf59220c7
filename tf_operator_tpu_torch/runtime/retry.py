"""Transient-error retry with decorrelated jitter: the port's copy of the
part of tf_operator_tpu/runtime/retry.py that the decode client and
server use (`RetryPolicy`, `call_with_retries`, `retry_after_hint`,
`RETRY_AFTER_CAP`). The reference's `RetryingSubstrate` is not part of
this copy.

Jitter is decorrelated (sleep = min(cap, uniform(base, 3*prev))): many
clients retrying one outage spread out instead of re-synchronizing into
waves. What is retried: HTTP 429 and the 5xx gateway/overload class
(anything carrying a `status` or `code` in TRANSIENT_HTTP_STATUSES) and
connection-level failures (ConnectionError, TimeoutError, URLError).
"""

from __future__ import annotations

import logging
import random
import time
import urllib.error
from typing import Callable, Iterator, Optional

from ..telemetry.flight import flight_record
from ..utils import locks

logger = logging.getLogger("tf_operator_tpu_torch.retry")

# 429 Too Many Requests + the 5xx gateway/overload class. 501 Not
# Implemented is deliberately absent (retrying it can never succeed).
TRANSIENT_HTTP_STATUSES = frozenset({429, 500, 502, 503, 504})

# Ceiling for a server-provided Retry-After hint: past this the caller is
# better off failing over.
RETRY_AFTER_CAP = 30.0


def is_transient_error(err: BaseException) -> bool:
    """True when a failed call may succeed if simply replayed."""
    status = getattr(err, "status", None) or getattr(err, "code", None)
    if isinstance(status, int):
        return status in TRANSIENT_HTTP_STATUSES
    return isinstance(err, (ConnectionError, TimeoutError, urllib.error.URLError))


class RetryPolicy:
    """Attempt budget + decorrelated-jitter delay schedule. One instance
    may be shared across threads (the rng is lock-guarded); each retried
    call draws its own delay chain via `delays()`."""

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay: float = 0.05,
        max_delay: float = 1.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.sleep = sleep
        self._rng = rng or random.Random()
        self._lock = locks.make_lock("RetryPolicy._lock")

    def _uniform(self, low: float, high: float) -> float:
        with self._lock:
            return self._rng.uniform(low, high)

    def delays(self) -> Iterator[float]:
        """The chain for ONE call: max_attempts-1 delays, each
        uniform(base, 3*prev) capped at max_delay."""
        prev = self.base_delay
        for _ in range(self.max_attempts - 1):
            prev = min(self.max_delay, self._uniform(self.base_delay, prev * 3))
            yield prev


def retry_after_hint(err: BaseException) -> Optional[float]:
    """Seconds from an HTTP error's Retry-After header (delta-seconds
    form only), or None."""
    headers = getattr(err, "headers", None)
    if headers is None:
        return None
    try:
        value = headers.get("Retry-After")
    except AttributeError:
        return None
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return None


def call_with_retries(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    classify: Callable[[BaseException], bool] = is_transient_error,
    on_retry: Optional[Callable[[str, int, BaseException], None]] = None,
    op: str = "",
    retry_after: Optional[Callable[[BaseException], Optional[float]]] = None,
    **kwargs,
):
    """Run fn, replaying transient failures per the policy's schedule.
    Non-transient errors propagate at once; the last transient failure
    (budget spent) propagates unchanged. retry_after: an optional hint
    extractor whose non-None answer overrides the jitter delay, capped at
    RETRY_AFTER_CAP."""
    policy = policy or RetryPolicy()
    name = op or getattr(fn, "__name__", "call")
    delays = policy.delays()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as err:  # noqa: BLE001 — classify() filters
            if not classify(err):
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            if retry_after is not None:
                hinted = retry_after(err)
                if hinted is not None:
                    delay = min(hinted, RETRY_AFTER_CAP)
            attempt += 1
            if on_retry is not None:
                on_retry(name, attempt, err)
            flight_record(
                "retry", op=name, attempt=attempt,
                error=type(err).__name__, delay=round(delay, 6),
            )
            logger.warning(
                "%s: transient error (%s); retry %d/%d in %.3fs",
                name, err, attempt, policy.max_attempts - 1, delay,
            )
            policy.sleep(delay)
