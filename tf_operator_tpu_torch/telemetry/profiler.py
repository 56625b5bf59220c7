"""Profilers: the port's copy of tf_operator_tpu/telemetry/profiler.py.

- `SamplingProfiler`: a background thread walks every thread's stack via
  `sys._current_frames()` at a set rate (default 99 Hz) and folds each
  stack into a semicolon-joined string stored in a preallocated bounded
  ring. Each sample carries a role derived from the thread's name (the
  decode engine, HTTP handlers, the trainer's step and input threads),
  so a profile attributes time to planes without symbolizing anything.
  The sampler measures its own duty cycle (`stats()["sample_seconds"]`
  over `elapsed_seconds`) so that the <2% overhead budget is asserted,
  not assumed. A tick is charged its wall time on the monotonic clock,
  as in the reference: it bounds the tick's CPU time from above. The
  thread CPU clock is no meter for it where it is a system call (a
  sandboxed kernel's, which charges the call's own wait to the tick it
  brackets and steps in 10 ms; PERF.md §6 measured both on an H100's
  host).
  `render_profilez` is the /debug/profilez page (`?action=start&hz=99`,
  `?action=stop`, and the default `?action=snapshot&seconds=5&format=
  folded|speedscope|json`; a snapshot with `seconds=` against a stopped
  profiler captures that window first). `write_signal_snapshot` is the
  SIGUSR2 capture (flight.install_crash_handlers): a daemon thread samples
  5 s and writes `profile-usr2-<pid>.json`. `profile_chrome_events`
  turns a payload into Perfetto tracks for the telemetry CLI.
- `StepProfiler`: the step-window device profiler (the reference's
  :667-724, where `jax.profiler` captures an XLA trace). Here
  `torch.profiler` records the host's operators and, where a CUDA card
  is present, the card's kernels (CUPTI), and writes one Chrome trace
  (Perfetto- and TensorBoard-readable) into `profile_dir`.
"""

from __future__ import annotations

import gc
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
    "profile_chrome_events", "write_signal_snapshot",
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
        parts.append(_frame_name(frame.f_code))
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


# each code object's "file.py:func", formatted once, keyed by the code
# object's id (a code object's own hash reads its whole bytecode); the
# entry holds the code object, so its id is not reused while cached
# (bounded: cleared when it outgrows _FRAME_NAMES_MAX)
_FRAME_NAMES: Dict[int, Tuple[object, str]] = {}
_FRAME_NAMES_MAX = 65536


def _frame_name(code) -> str:
    entry = _FRAME_NAMES.get(id(code))
    if entry is None or entry[0] is not code:
        if len(_FRAME_NAMES) >= _FRAME_NAMES_MAX:
            _FRAME_NAMES.clear()
        entry = _FRAME_NAMES[id(code)] = (
            code, f"{code.co_filename.rsplit(os.sep, 1)[-1]}:{code.co_name}")
    return entry[1]


# a stack's fold, keyed by the ids of its code objects leaf first; the
# entry holds those code objects, so no id in a cached key is reused
# while the entry lives (bounded: cleared when it outgrows _FOLDS_MAX)
_FOLDS_MAX = 65536


def _walk(frame, folds: Dict[tuple, Tuple[str, list]], limit: int = MAX_STACK_DEPTH) -> str:
    """The _fold of `frame` (its `limit` frames nearest the leaf),
    formatted once a distinct stack: the walk reads each frame's code
    object only and holds no frame past the tick. A frame held to the
    next tick would, once its thread had left it, own its locals, and the
    sampler would free them (tensors, autograd graphs: a stepping
    thread's work; on an H100's host, in a long-lived process, that made
    a tick 2.4x as long: PERF.md §6)."""
    codes = []
    append = codes.append
    for _ in range(limit):
        if frame is None:
            break
        append(frame.f_code)
        frame = frame.f_back
    key = tuple(map(id, codes))
    entry = folds.get(key)
    if entry is None:
        if len(folds) >= _FOLDS_MAX:
            folds.clear()
        codes.reverse()
        entry = folds[key] = (";".join([_frame_name(code) for code in codes]), codes)
    return entry[0]


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
        # the GIL while inside _sample_once); the longest tick shows
        # what else a tick can wait for
        self._sample_seconds = 0.0
        self._max_tick_seconds = 0.0
        self._ticks = 0
        # each distinct stack's fold (_walk) and each thread's (name, role)
        self._folds: Dict[tuple, Tuple[str, list]] = {}
        self._threads: Dict[int, Tuple[str, str]] = {}

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
            # the cyclic collector waits while a tick holds the GIL: a
            # collection that the tick's allocations would trigger (a pass
            # over the whole process's heap, the work of every thread's
            # garbage) then runs on the next thread to allocate, and is
            # not charged to the sampler
            collect = gc.isenabled()
            if collect:
                gc.disable()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — the sampler observes a
                # process; it must never take one down (a thread dying
                # mid-walk can surface RuntimeError from frame access)
                pass
            finally:
                if collect:
                    gc.enable()
            tick = time.monotonic() - t0
            self._sample_seconds += tick
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
        frames = sys._current_frames()
        del frames[threading.get_ident()]  # the sampler never profiles itself
        t = time.monotonic()
        wall = time.time()  # noqa — deliberate calendar stamp on the sample
        threads = self._threads
        if not frames.keys() <= threads.keys():
            # a thread started since the last tick: name every thread anew
            names = {th.ident: th.name for th in threading.enumerate()}
            threads = {ident: (name, self._role_of(name)) for ident in frames
                       for name in (names.get(ident) or f"thread-{ident}",)}
            self._threads = threads
        # every stack walked whole: no other thread runs Python while the
        # tick holds the GIL, so no frame read here is left before the
        # tick lets go of it
        folds, buf, capacity = self._folds, self._buf, self.capacity
        new = tuple.__new__  # a ProfileSample without its Python-level constructor
        with self._lock:
            seq = self._seq
            for ident, frame in frames.items():
                buf[seq % capacity] = new(ProfileSample, (
                    seq, t, wall, threads[ident][1], _walk(frame, folds)))
                seq += 1
            self._seq = seq
        return len(frames)

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


def profile_chrome_events(
    payload: Dict[str, object], pid: int = 1, tid_base: int = 20_000
) -> List[dict]:
    """A to_json() payload as Chrome/Perfetto events: one track per role
    of instant events, one per distinct folded stack, weighted through
    args (counts): enough to see which code ran during a span or flight
    window when the CLI merges them into one file."""
    folded = payload.get("folded") or {}
    wall_start = payload.get("wall_start") or 0.0
    tracks: Dict[str, int] = {}
    events: List[dict] = []
    for stack, count in sorted(folded.items()):
        parts = stack.split(";")
        role, frames = parts[0], parts[1:]
        tid = tracks.setdefault(role, tid_base + len(tracks))
        leaf = frames[-1] if frames else role
        events.append({
            "name": leaf,
            "cat": "profile",
            "ph": "i",
            "ts": round(float(wall_start) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "s": "t",
            "args": {"stack": stack, "count": count, "role": role},
        })
    meta = [{
        "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": f"profile:{role}"},
    } for role, tid in tracks.items()]
    return meta + events


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


# -- SIGUSR2 -----------------------------------------------------------------

def write_signal_snapshot(
    directory: str,
    seconds: float = 5.0,
    hz: int = DEFAULT_HZ,
    profiler: Optional[SamplingProfiler] = None,
) -> str:
    """Capture a `seconds` profile without blocking the caller (a signal
    handler): a daemon thread samples the window through the sampler
    (which charges a tick its CPU time) and writes
    ``profile-usr2-<pid>.json`` (a to_json() payload) to `directory`;
    -> the path that will be written. If the process-wide profiler is
    already running, the window elapses on it."""
    prof = profiler if profiler is not None else default_profiler()
    path = os.path.join(directory, f"profile-usr2-{os.getpid()}.json")

    def _capture() -> None:
        try:
            prof.capture(seconds, hz=hz)
            with open(path, "w") as f:
                json.dump(prof.to_json(seconds=seconds), f)
        except Exception:  # noqa: BLE001 — a diagnostics thread must never
            # surface as a crash in the process it observes
            pass

    threading.Thread(target=_capture, name="profiler-usr2", daemon=True).start()
    return path


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
