"""Injectable clock: the port's copy of the part of
tf_operator_tpu/controller/clock.py that the trainer reads.

``monotonic()`` is interval time, for durations measured locally (the
trainer's step phases and goodput ledger time through it). `FakeClock`
advances only when told, so tests drive it deterministically. The wall
face (``now()``) comes with the first port module that reads it.
"""

from __future__ import annotations

import time


class Clock:
    def monotonic(self) -> float:
        return time.monotonic()


class FakeClock(Clock):
    """Starts at 0; advances only when told."""

    def __init__(self) -> None:
        self._mono = 0.0

    def monotonic(self) -> float:
        return self._mono

    def advance(self, seconds: float) -> None:
        self._mono += seconds
