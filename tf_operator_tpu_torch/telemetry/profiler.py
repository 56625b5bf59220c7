"""Step-window device profiler: the port of `StepProfiler` from
tf_operator_tpu/telemetry/profiler.py (:667-724), where `jax.profiler`
captures an XLA trace. Here `torch.profiler` records the host's operators
and, where a CUDA card is present, the card's kernels (CUPTI), and writes
one Chrome trace (Perfetto- and TensorBoard-readable) into `profile_dir`.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Tuple

import torch

_logger = logging.getLogger("tf_operator_tpu_torch.telemetry.profiler")


class StepProfiler:
    """Captures steps [start, stop) of a training loop into
    ``profile_dir/steps_<start>_<stop>.pt.trace.json``.

    Usage:
        profiler = StepProfiler(args.profile_dir, total_steps, (3, 8))
        for i in range(total_steps):
            profiler.before_step(i)
            ... run step i ...
            profiler.after_step(i, drain=lambda: float(loss))

    A None or empty profile_dir makes every call a no-op. The rules are
    the reference's: the window skips the warm-up (window[0] defaults
    past it), the device drains before the trace stops (`drain`, then a
    synchronize of every card the trace watched), and `close()` always
    stops an open trace, so a loop that ends early or raises still
    writes it.
    """

    def __init__(
        self,
        profile_dir: Optional[str],
        total_steps: int,
        window: Tuple[int, int] = (3, 8),
    ) -> None:
        self.profile_dir = profile_dir or None
        self.trace_path: Optional[str] = None
        self._profile = None
        if self.profile_dir is None or total_steps <= 0:
            self.start_step = self.stop_after = -1
            return
        # clamp into the run: short runs still produce a trace
        self.start_step = min(window[0], total_steps - 1)
        self.stop_after = min(max(window[1], self.start_step + 1), total_steps)

    @property
    def active(self) -> bool:
        return self._profile is not None

    def before_step(self, i: int) -> None:
        if self.profile_dir is not None and i == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profile = profile(activities=activities)
            self._profile.__enter__()

    def after_step(self, i: int, drain: Optional[Callable[[], object]] = None) -> None:
        if self._profile is not None and i + 1 >= self.stop_after:
            self._stop(drain)

    def close(self, drain: Optional[Callable[[], object]] = None) -> None:
        """Safety net for loops that end before the window does."""
        if self._profile is not None:
            self._stop(drain)

    def _stop(self, drain) -> None:
        prof, self._profile = self._profile, None
        try:
            if drain is not None:
                drain()  # wait for in-flight device work so the trace is complete
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            prof.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.profile_dir, f"steps_{self.start_step}_{self.stop_after}.pt.trace.json"
            )
            prof.export_chrome_trace(self.trace_path)
            _logger.info("profiler trace written to %s", self.trace_path)
