"""Controller expectations: don't act on a stale cache.

Port of the k8s ControllerExpectations model the reference leans on
(reference jobcontroller.go:111-124 and its use at controller.go:514-533,
jobcontroller/pod.go:20-64). After issuing N creates the controller
"expects" to observe N informer ADDs before it trusts its cache again;
until then (or until a TTL expires as a failsafe) the sync loop must
not create more children, or informer lag causes double-creates —
SURVEY.md §7 ranks this the #2 hard part.

The port's copy of tf_operator_tpu/runtime/expectations.py; it imports nothing of that package.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

from ..utils import locks

EXPECTATION_TTL_SECONDS = 5 * 60.0  # k8s ExpectationsTimeout


class ControllerExpectations:
    def __init__(self, ttl: float = EXPECTATION_TTL_SECONDS) -> None:
        self._ttl = ttl
        self._lock = locks.make_lock("ControllerExpectations._lock")
        # key -> (adds_expected, deletes_expected, timestamp)
        self._store: Dict[str, Tuple[int, int, float]] = {}

    def expect_creations(self, key: str, count: int) -> None:
        self._set(key, adds=count, deletes=0)

    def expect_deletions(self, key: str, count: int) -> None:
        self._set(key, adds=0, deletes=count)

    def raise_expectations(self, key: str, adds: int, deletes: int) -> None:
        with self._lock:
            old_adds, old_deletes, _ = self._store.get(key, (0, 0, 0.0))
            self._store[key] = (old_adds + adds, old_deletes + deletes, time.monotonic())

    def _set(self, key: str, adds: int, deletes: int) -> None:
        with self._lock:
            self._store[key] = (adds, deletes, time.monotonic())

    def creation_observed(self, key: str) -> None:
        self._lower(key, adds=1, deletes=0)

    def deletion_observed(self, key: str) -> None:
        self._lower(key, adds=0, deletes=1)

    def _lower(self, key: str, adds: int, deletes: int) -> None:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                return
            old_adds, old_deletes, ts = entry
            # floor at 0: an unexpected observation must not corrupt
            # accounting for later expectations on the same key
            self._store[key] = (
                max(0, old_adds - adds),
                max(0, old_deletes - deletes),
                ts,
            )

    def satisfied(self, key: str) -> bool:
        """True if the cache can be trusted for this key: no outstanding
        expectations, or the TTL failsafe expired (matching k8s
        SatisfiedExpectations: fulfilled OR expired OR never set)."""
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                return True
            adds, deletes, ts = entry
            if adds <= 0 and deletes <= 0:
                return True
            return time.monotonic() - ts > self._ttl

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def rebuild_from_observed(self, keys: Iterable[str]) -> None:
        """Crash-recovery reset (docs/ha.md): a leader taking over must
        not trust counters accumulated by a previous term — they count
        watch events a different process saw, so any nonzero residue
        would either block syncs until the TTL failsafe or, worse, let
        a sync run against a cache it shouldn't trust. Clear every key
        derivable from the relist (jobs × replica types plus observed
        children, orphans included) so each next sync starts from
        "satisfied" and recomputes the world purely from what it lists.

        `keys` is the relist-derived universe. This implementation can
        go further and drop everything (entries outside the universe
        belong to owners that no longer exist); the parameter exists so
        NativeExpectations — whose store cannot be enumerated from
        Python — implements the same contract by per-key deletion."""
        del keys  # see docstring: full clear subsumes the key set
        with self._lock:
            self._store.clear()
