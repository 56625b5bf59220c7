"""Profilers: the port's copy of tf_operator_tpu/telemetry/profiler.py.

- `SamplingProfiler`: a background thread walks every thread's stack via
  `sys._current_frames()` at a set rate (default 99 Hz) and folds each
  stack into a semicolon-joined string stored in a preallocated bounded
  ring. Each sample carries a role derived from the thread's name (the
  decode engine, HTTP handlers, the trainer's step and input threads),
  so a profile attributes time to planes without symbolizing anything.
  The sampler measures its own duty cycle (`stats()["sample_seconds"]`
  over `elapsed_seconds`) so that the <2% overhead budget is asserted,
  not assumed. A tick is charged the sampler thread's CPU time
  (`time.thread_time`): its wall time (`sample_wall_seconds`) also holds
  the stretches it waits for the GIL or for a core, which are other
  threads' time (PERF.md §7 has both, measured beside training threads
  on an H100).
  `render_profilez` is the /debug/profilez page (`?action=start&hz=99`,
  `?action=stop`, and the default `?action=snapshot&seconds=5&format=
  folded|speedscope|json`; a snapshot with `seconds=` against a stopped
  profiler captures that window first). The reference's SIGUSR2
  snapshot is not part of this copy.
- `StepProfiler`: the step-window device profiler (the reference's
  :667-724, where `jax.profiler` captures an XLA trace). Here
  `torch.profiler` records the host's operators and, where a CUDA card
  is present, the card's kernels (CUPTI), and writes one Chrome trace
  (Perfetto- and TensorBoard-readable) into `profile_dir`.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from ..utils import locks

_logger = logging.getLogger("tf_operator_tpu_torch.telemetry.profiler")

__all__ = [
    "ProfileSample", "SamplingProfiler", "StepProfiler", "default_profiler",
    "set_default_profiler", "render_profilez", "top_table", "speedscope_from_folded",
]

DEFAULT_HZ = 99
DEFAULT_CAPACITY = 65536
MAX_STACK_DEPTH = 64
# blocking-capture bound for /debug/profilez?seconds= (an HTTP handler
# thread parks for the window; keep a curl typo from parking it a day)
MAX_CAPTURE_SECONDS = 60.0

# thread-name fragment -> role. Matched in order, first hit wins; a
# miss falls back to the thread's own name so custom threads
# self-describe. process_request_thread is how ThreadingHTTPServer
# names its per-connection handlers (both planes' HTTP edges).
_DEFAULT_ROLES: Tuple[Tuple[str, str], ...] = (
    ("decode-engine", "engine"),
    ("decode-batcher", "engine"),
    ("metric-history", "monitoring"),
    ("alert-manager", "monitoring"),
    ("process_request_thread", "server"),
    # trainer threads (train/input_pipeline.py, train/trainer.py's
    # checkpoint writer, train/observe.py): the
    # step loop runs on MainThread in the CLIs, on named train-step
    # threads in the observe smoke
    ("input-pipeline", "train-input"),
    ("checkpoint-writer", "train-checkpoint"),
    ("train-telemetry", "train-step"),
    ("train-step", "train-step"),
    ("MainThread", "main"),
)


class ProfileSample(NamedTuple):
    """One ring entry: a folded stack observed on one thread at one
    tick. `stack` is root-first, semicolon-joined `file.py:func`
    frames (no line numbers — folding must be deterministic for a
    steady workload)."""

    seq: int
    t: float
    wall: float
    role: str
    stack: str


def _fold(frame, limit: int = MAX_STACK_DEPTH) -> str:
    """frame -> "root.py:f1;mid.py:f2;leaf.py:f3". Leaf LAST (the
    flamegraph convention: self time lives at the end)."""
    parts: List[str] = []
    while frame is not None and len(parts) < limit:
        code = frame.f_code
        parts.append(
            f"{code.co_filename.rsplit(os.sep, 1)[-1]}:{code.co_name}"
        )
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Low-overhead wall-clock sampler over all threads.

    start()/stop() are idempotent; a running profiler samples into the
    bounded ring until stopped (overwrite-oldest, the FlightRecorder
    discipline — always-on never means unbounded). snapshot()/folded()
    read the ring; capture() is the blocking start-sleep-stop
    convenience the HTTP endpoint uses."""

    def __init__(
        self,
        hz: int = DEFAULT_HZ,
        capacity: int = DEFAULT_CAPACITY,
    ) -> None:
        if hz < 1:
            raise ValueError(f"hz must be >= 1, got {hz}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.hz = int(hz)
        self.capacity = int(capacity)
        self._lock = locks.make_lock("SamplingProfiler._lock")
        # preallocated ring, overwrite-oldest (FlightRecorder pattern)
        self._buf: List[Optional[ProfileSample]] = [None] * self.capacity
        self._seq = 0
        self._roles: List[Tuple[str, str]] = list(_DEFAULT_ROLES)
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._started_at: Optional[float] = None
        # sampler self-accounting: duty cycle = sample_seconds /
        # elapsed is THE overhead bound (the sampler only contends for
        # the GIL while inside _sample_once). sample_seconds is the
        # sampler thread's CPU time in its ticks; the same ticks on the
        # wall clock, and the longest of them, show what else a tick
        # waited for
        self._sample_seconds = 0.0
        self._sample_wall_seconds = 0.0
        self._max_tick_seconds = 0.0
        self._ticks = 0

    # -- roles ---------------------------------------------------------------

    def register_role(self, fragment: str, role: str) -> None:
        """Map thread names containing `fragment` to `role` (checked
        before the defaults, so embedders can override)."""
        with self._lock:
            self._roles.insert(0, (str(fragment), str(role)))

    def _role_of(self, name: str) -> str:
        for fragment, role in self._roles:
            if fragment in name:
                return role
        return name

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def start(self, hz: Optional[int] = None) -> bool:
        """Begin sampling; -> True if this call started the sampler,
        False if it was already running (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            if hz is not None:
                if hz < 1:
                    raise ValueError(f"hz must be >= 1, got {hz}")
                self.hz = int(hz)
            self._stop_event = threading.Event()
            self._started_at = time.monotonic()
            thread = threading.Thread(
                target=self._loop, name="profiler-sampler", daemon=True
            )
            self._thread = thread
        thread.start()
        return True

    def stop(self) -> bool:
        """Stop sampling; -> True if this call stopped a running
        sampler, False if it was already stopped (idempotent). The
        ring keeps its samples for post-stop snapshots."""
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is None or not thread.is_alive():
            return False
        self._stop_event.set()
        thread.join(timeout=2.0)
        return True

    def capture(self, seconds: float, hz: Optional[int] = None) -> int:
        """Blocking convenience: sample for `seconds`, then stop; ->
        samples taken during the window. If the profiler was already
        running it is left running (the window just elapses)."""
        seconds = max(0.01, float(seconds))
        before = self.total_sampled
        started_here = self.start(hz=hz)
        time.sleep(seconds)
        if started_here:
            self.stop()
        return self.total_sampled - before

    # -- sampling ------------------------------------------------------------

    def _loop(self) -> None:
        period = 1.0 / self.hz
        stop = self._stop_event
        next_t = time.monotonic()
        while not stop.is_set():
            t0 = time.monotonic()
            c0 = time.thread_time()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — the sampler observes a
                # process; it must never take one down (a thread dying
                # mid-walk can surface RuntimeError from frame access)
                pass
            tick = time.monotonic() - t0
            self._sample_seconds += time.thread_time() - c0
            self._sample_wall_seconds += tick
            self._max_tick_seconds = max(self._max_tick_seconds, tick)
            self._ticks += 1
            next_t += period
            delay = next_t - time.monotonic()
            if delay <= 0:
                # fell behind (a long GC pause, a loaded box): resync
                # instead of bursting to catch up — burst samples would
                # overweight whatever ran during the stall
                next_t = time.monotonic()
                continue
            stop.wait(delay)

    def _sample_once(self) -> int:
        """Walk every thread's current stack once; -> threads sampled.
        Public enough for tests to drive the ring deterministically."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        t = time.monotonic()
        wall = time.time()  # noqa — deliberate calendar stamp on the sample
        folded: List[Tuple[str, str]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # the sampler never profiles itself
            name = names.get(ident) or f"thread-{ident}"
            folded.append((self._role_of(name), _fold(frame)))
        with self._lock:
            for role, stack in folded:
                seq = self._seq
                self._seq = seq + 1
                self._buf[seq % self.capacity] = ProfileSample(
                    seq, t, wall, role, stack
                )
        return len(folded)

    # -- reads ---------------------------------------------------------------

    @property
    def total_sampled(self) -> int:
        """Samples ever taken (>= len of ring: the ring overwrites)."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._seq = 0

    def snapshot(
        self,
        seconds: Optional[float] = None,
        role: Optional[str] = None,
    ) -> List[ProfileSample]:
        """Samples currently in the ring, oldest first; `seconds=`
        keeps only the trailing window, `role=` filters one plane."""
        with self._lock:
            seq = self._seq
            buf = list(self._buf)
        start = max(0, seq - self.capacity)
        samples = [
            s for i in range(start, seq)
            if (s := buf[i % self.capacity]) is not None
        ]
        if seconds is not None and samples:
            cutoff = samples[-1].t - float(seconds)
            samples = [s for s in samples if s.t >= cutoff]
        if role is not None:
            samples = [s for s in samples if s.role == role]
        return samples

    def folded(self, seconds: Optional[float] = None) -> Dict[str, int]:
        """Aggregated folded stacks: "role;root;...;leaf" -> count —
        the flamegraph.pl / speedscope-importable text form."""
        counts: Dict[str, int] = {}
        for s in self.snapshot(seconds=seconds):
            key = f"{s.role};{s.stack}" if s.stack else s.role
            counts[key] = counts.get(key, 0) + 1
        return counts

    def stats(self) -> Dict[str, object]:
        started = self._started_at
        elapsed = (
            time.monotonic() - started
            if (started is not None and self.running) else None
        )
        return {
            "running": self.running,
            "hz": self.hz,
            "capacity": self.capacity,
            "samples_total": self.total_sampled,
            "samples_in_ring": len(self),
            "ticks": self._ticks,
            "sample_seconds": round(self._sample_seconds, 6),
            "sample_wall_seconds": round(self._sample_wall_seconds, 6),
            "max_tick_seconds": round(self._max_tick_seconds, 6),
            "elapsed_seconds": (
                round(elapsed, 6) if elapsed is not None else None
            ),
            "roles": sorted({s.role for s in self.snapshot()}),
        }

    def to_json(self, seconds: Optional[float] = None) -> Dict[str, object]:
        """The JSON snapshot (`format=json`): folded
        counts plus enough metadata to weight them (1/hz seconds per
        sample)."""
        samples = self.snapshot(seconds=seconds)
        counts: Dict[str, int] = {}
        for s in samples:
            key = f"{s.role};{s.stack}" if s.stack else s.role
            counts[key] = counts.get(key, 0) + 1
        duration = (
            round(samples[-1].t - samples[0].t, 6) if len(samples) > 1
            else 0.0
        )
        return {
            "profile": "tf-operator-tpu-sampling",
            "hz": self.hz,
            "samples": len(samples),
            "duration_seconds": duration,
            "wall_start": samples[0].wall if samples else None,
            "wall_end": samples[-1].wall if samples else None,
            "stats": self.stats(),
            "folded": counts,
        }

    def speedscope(self, seconds: Optional[float] = None) -> Dict[str, object]:
        """Speedscope file-format JSON: one sampled profile per role
        (drop the dict on speedscope.app as-is)."""
        samples = self.snapshot(seconds=seconds)
        frames: List[Dict[str, str]] = []
        index: Dict[str, int] = {}

        def frame_index(name: str) -> int:
            i = index.get(name)
            if i is None:
                i = len(frames)
                index[name] = i
                frames.append({"name": name})
            return i

        weight = 1.0 / self.hz
        by_role: Dict[str, Dict[str, List]] = {}
        for s in samples:
            prof = by_role.setdefault(
                s.role, {"samples": [], "weights": []}
            )
            stack = [
                frame_index(part) for part in s.stack.split(";") if part
            ]
            prof["samples"].append(stack)
            prof["weights"].append(weight)
        profiles = [
            {
                "type": "sampled",
                "name": role,
                "unit": "seconds",
                "startValue": 0,
                "endValue": round(sum(prof["weights"]), 6),
                "samples": prof["samples"],
                "weights": prof["weights"],
            }
            for role, prof in sorted(by_role.items())
        ]
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": "tf-operator-tpu profile",
            "exporter": "tf_operator_tpu.telemetry.profiler",
            "shared": {"frames": frames},
            "profiles": profiles,
        }


# -- process-wide default ----------------------------------------------------

_default: SamplingProfiler = SamplingProfiler()


def default_profiler() -> SamplingProfiler:
    """The process-wide profiler /debug/profilez serves:
    one ring per process, whichever plane starts it."""
    return _default


def set_default_profiler(profiler: SamplingProfiler) -> SamplingProfiler:
    """Swap the process-wide profiler (tests isolate through this);
    -> the profiler passed in."""
    global _default
    _default = profiler
    return profiler


# -- analysis ---------------------------------------------------------------

def top_table(
    folded: Dict[str, int], n: int = 15
) -> Dict[str, List[Tuple[str, int]]]:
    """folded counts -> {"self": [(frame, count)...], "cumulative":
    [...], "roles": [...]} sorted descending, top n each. Self = the
    leaf frame of each stack; cumulative = every frame anywhere in a
    stack (counted once per stack); roles = the leading role tag."""
    self_counts: Dict[str, int] = {}
    cum_counts: Dict[str, int] = {}
    role_counts: Dict[str, int] = {}
    for stack, count in folded.items():
        parts = stack.split(";")
        role, frames = parts[0], parts[1:]
        role_counts[role] = role_counts.get(role, 0) + count
        if not frames:
            continue
        leaf = frames[-1]
        self_counts[leaf] = self_counts.get(leaf, 0) + count
        for frame in set(frames):
            cum_counts[frame] = cum_counts.get(frame, 0) + count

    def top(counts: Dict[str, int]) -> List[Tuple[str, int]]:
        return sorted(
            counts.items(), key=lambda kv: (-kv[1], kv[0])
        )[:n]

    return {
        "self": top(self_counts),
        "cumulative": top(cum_counts),
        "roles": top(role_counts),
    }


def speedscope_from_folded(payload: Dict[str, object]) -> Dict[str, object]:
    """A to_json() payload -> speedscope file-format JSON. The folded
    counts already aggregate identical stacks, so each becomes one
    sample weighted count/hz, so a saved payload renders without
    needing the live ring."""
    folded = payload.get("folded") or {}
    hz = float(payload.get("hz") or DEFAULT_HZ)
    frames: List[Dict[str, str]] = []
    index: Dict[str, int] = {}

    def frame_index(name: str) -> int:
        i = index.get(name)
        if i is None:
            i = len(frames)
            index[name] = i
            frames.append({"name": name})
        return i

    by_role: Dict[str, Dict[str, List]] = {}
    for stack, count in sorted(folded.items()):
        parts = stack.split(";")
        role, fs = parts[0], parts[1:]
        prof = by_role.setdefault(role, {"samples": [], "weights": []})
        prof["samples"].append([frame_index(f) for f in fs if f])
        prof["weights"].append(round(count / hz, 6))
    profiles = [
        {
            "type": "sampled",
            "name": role,
            "unit": "seconds",
            "startValue": 0,
            "endValue": round(sum(prof["weights"]), 6),
            "samples": prof["samples"],
            "weights": prof["weights"],
        }
        for role, prof in sorted(by_role.items())
    ]
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": "tf-operator-tpu profile",
        "exporter": "tf_operator_tpu.telemetry.profiler",
        "shared": {"frames": frames},
        "profiles": profiles,
    }


# -- /debug/profilez ---------------------------------------------------------

def render_profilez(
    profiler: SamplingProfiler, query: str = ""
) -> Tuple[str, bytes]:
    """The shared /debug/profilez page -> (content_type, body).

    `?action=start&hz=99` / `?action=stop` control the always-on
    sampler; the default `?action=snapshot` reads the ring
    (`seconds=` trailing window, `format=folded|speedscope|json`).
    A snapshot with `seconds=` against a STOPPED profiler performs a
    blocking capture of that window first — one curl profiles a live
    process with no prior setup."""
    from urllib.parse import parse_qs

    params = parse_qs(query or "", keep_blank_values=False)

    def first(name: str) -> Optional[str]:
        values = params.get(name)
        return values[0] if values else None

    def number(name: str, cast):
        raw = first(name)
        if raw is None:
            return None
        try:
            return cast(raw)
        except ValueError:
            return None

    action = first("action") or "snapshot"
    hz = number("hz", int)
    seconds = number("seconds", float)
    fmt = first("format") or "folded"

    if action == "start":
        started = profiler.start(hz=hz if hz and hz > 0 else None)
        body = json.dumps(
            {"action": "start", "started": started, **profiler.stats()}
        ).encode()
        return "application/json", body
    if action == "stop":
        stopped = profiler.stop()
        body = json.dumps(
            {"action": "stop", "stopped": stopped, **profiler.stats()}
        ).encode()
        return "application/json", body

    # snapshot
    if seconds is not None:
        seconds = min(max(0.05, seconds), MAX_CAPTURE_SECONDS)
        if not profiler.running:
            profiler.capture(seconds, hz=hz if hz and hz > 0 else None)
    if fmt == "speedscope":
        return "application/json", json.dumps(
            profiler.speedscope(seconds=seconds)
        ).encode()
    if fmt == "json":
        return "application/json", json.dumps(
            profiler.to_json(seconds=seconds)
        ).encode()
    lines = [
        f"{stack} {count}"
        for stack, count in sorted(profiler.folded(seconds=seconds).items())
    ]
    return "text/plain; charset=utf-8", (
        ("\n".join(lines) + "\n") if lines else ""
    ).encode()



# -- the step-window device profiler -------------------------------------

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
            import torch
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
        import torch

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
