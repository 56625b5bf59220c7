"""Injectable clock: the port's copy of tf_operator_tpu/controller/clock.py.

Two faces, deliberately separate:

- ``now()`` is WALL time, for values that leave the process (the metric
  history stamps each sample with it).
- ``monotonic()`` is INTERVAL time, for durations measured locally (the
  trainer's step phases, the goodput ledger, the alert state machine).

`FakeClock` advances only when told, both faces together, so tests drive
it deterministically.
"""

from __future__ import annotations

import datetime
import time


def parse_iso(ts: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))


class Clock:
    def now(self) -> datetime.datetime:
        return datetime.datetime.now(datetime.timezone.utc)

    def monotonic(self) -> float:
        return time.monotonic()


class FakeClock(Clock):
    """Starts at a fixed instant (monotonic 0); advances only when told."""

    def __init__(self, start: str = "2026-01-01T00:00:00Z") -> None:
        self._now = parse_iso(start)
        self._mono = 0.0

    def now(self) -> datetime.datetime:
        return self._now

    def monotonic(self) -> float:
        return self._mono

    def advance(self, seconds: float) -> None:
        self._now += datetime.timedelta(seconds=seconds)
        self._mono += seconds
