"""Controller-side helpers the port copies: the injectable clock."""

from .clock import Clock, FakeClock

__all__ = ["Clock", "FakeClock"]
