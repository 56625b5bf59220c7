"""Flight recorder: the port's copy of the ring buffer of
tf_operator_tpu/telemetry/flight.py that the trainer records into.

A preallocated, bounded ring of typed records (trainer step stats,
checkpoint saves, preemptions, step-phase splits). Recording is one clock
read and one slot store under a lock; a disabled recorder returns before
touching the lock. Each record carries the correlation id bound by
`correlate()` (the server's request id), and a bound trace context
(tracecontext.trace_scope) lands in its fields as "trace"/"span".
`render_flightz` is the /debug/flightz page the decode server and the
trainer telemetry server serve.

The crash surfaces: `install_crash_handlers()` dumps the ring as JSONL
from `sys.excepthook` (the postmortem survives the crash) and on SIGUSR2
(a live snapshot, `faulthandler`'s all-thread stacks and a 5 s sampled
profile: what a wedged process is doing right now), into
$TF_OPERATOR_FLIGHT_DIR or the temp dir. `flight_chrome_events` exports
records as Perfetto instants, one track per correlation id, for
`python -m tf_operator_tpu_torch.telemetry`.
"""

from __future__ import annotations

import contextvars
import faulthandler
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

from ..utils import locks
from .tracecontext import current_trace

__all__ = [
    "FlightRecord", "FlightRecorder", "correlate", "current_correlation",
    "default_flight", "set_default_flight", "flight_record",
    "install_crash_handlers", "render_flightz", "flight_chrome_events",
]

_correlation: contextvars.ContextVar = contextvars.ContextVar(
    "telemetry_correlation_id", default=None
)


def current_correlation() -> Optional[str]:
    """The correlation ID bound to the current context, or None."""
    return _correlation.get()


class correlate:
    """Bind a correlation ID for a block::

        with correlate("req-7"):
            ...  # spans begun here carry it

    Nests: the previous binding is restored on exit. A None id binds
    nothing new."""

    __slots__ = ("corr", "_token")

    def __init__(self, corr) -> None:
        self.corr = None if corr is None else str(corr)

    def __enter__(self) -> Optional[str]:
        if self.corr is None:
            self._token = None
            return _correlation.get()
        self._token = _correlation.set(self.corr)
        return self.corr

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _correlation.reset(self._token)


class FlightRecord(NamedTuple):
    """One ring entry. `t` is monotonic seconds (ordering and deltas),
    `wall` is epoch seconds (joining records across processes)."""

    seq: int
    t: float
    wall: float
    kind: str
    corr: Optional[str]
    fields: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "t": round(self.t, 6),
            "wall": round(self.wall, 6),
            "kind": self.kind,
            "corr": self.corr,
            "fields": {k: _jsonable(v) for k, v in self.fields.items()},
        }


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


class FlightRecorder:
    """Bounded ring of FlightRecords. Thread-safe; overwrite-oldest."""

    def __init__(
        self, capacity: int = 4096, clock=time.monotonic, enabled: bool = True,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = locks.make_lock("FlightRecorder._lock")
        self._buf: List[Optional[FlightRecord]] = [None] * self.capacity
        self._seq = 0

    def record(self, kind: str, corr: Optional[str] = None, **fields) -> Optional[FlightRecord]:
        """Append one record; -> it, or None when disabled. corr defaults
        to the context's `correlate()` binding; an explicit trace= field
        wins over the bound trace context (threads outside the request
        context, such as the engine's, pass the trace captured at
        submit)."""
        if not self.enabled:
            return None
        if corr is None:
            corr = _correlation.get()
        if fields.get("trace") is None:
            ctx = current_trace()
            if ctx is not None:
                fields["trace"] = ctx.trace_id
                fields["span"] = ctx.span_id
            elif "trace" in fields:
                del fields["trace"]
        t = self._clock()
        wall = time.time()
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            record = FlightRecord(seq, t, wall, kind, corr, fields)
            self._buf[seq % self.capacity] = record
        return record

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    def snapshot(
        self, kind: Optional[str] = None, corr: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[FlightRecord]:
        """Records in the ring, oldest first, optionally of one kind
        and/or correlation id; `limit` keeps the newest N after
        filtering."""
        with self._lock:
            seq = self._seq
            buf = list(self._buf)
        start = max(0, seq - self.capacity)
        records = [
            r for i in range(start, seq) if (r := buf[i % self.capacity]) is not None
        ]
        if kind is not None:
            records = [r for r in records if r.kind == kind]
        if corr is not None:
            records = [r for r in records if r.corr == corr]
        if limit is not None and limit > 0:
            records = records[-limit:]
        return records

    def to_jsonl(self, **filters) -> str:
        records = self.snapshot(**filters)
        if not records:
            return ""
        return "\n".join(json.dumps(r.to_dict()) for r in records) + "\n"

    def crash_dump(self, path: str) -> str:
        """Crash- and signal-safe dump: never blocks for long on the
        ring lock. A signal handler runs on the main thread between
        bytecodes; if the signal lands while that thread is inside
        record() holding the lock (a plain, non-reentrant Lock), a
        blocking acquire would deadlock the process. So the lock is
        taken with a short timeout and, failing that, the ring is
        copied without it: slots are replaced whole, never mutated in
        place, so the worst case is one torn (missing or duplicate)
        record in the dump."""
        acquired = self._lock.acquire(timeout=0.25)
        try:
            seq = self._seq
            buf = list(self._buf)
        finally:
            if acquired:
                self._lock.release()
        start = max(0, seq - self.capacity)
        records = [
            r for i in range(start, seq) if (r := buf[i % self.capacity]) is not None
        ]
        with open(path, "w") as f:
            for r in records:
                f.write(json.dumps(r.to_dict()) + "\n")
        return path


_default = FlightRecorder()


def default_flight() -> FlightRecorder:
    """The process-wide recorder every component records into by default."""
    return _default


def set_default_flight(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide recorder (tests isolate through this)."""
    global _default
    _default = recorder
    return recorder


def flight_record(kind: str, corr: Optional[str] = None, **fields) -> Optional[FlightRecord]:
    """record() on the process-wide default recorder."""
    return _default.record(kind, corr=corr, **fields)


# -- crash / signal dumps ----------------------------------------------------

def _dump_dir() -> str:
    return os.environ.get("TF_OPERATOR_FLIGHT_DIR") or tempfile.gettempdir()


class CrashHandles:
    """What install_crash_handlers() armed; uninstall() restores the
    hooks that were there before, and `dumps` lists the files written."""

    def __init__(self) -> None:
        self.dumps: List[str] = []
        self._restores: List = []

    def _add_restore(self, fn) -> None:
        self._restores.append(fn)

    def uninstall(self) -> None:
        while self._restores:
            self._restores.pop()()


def install_crash_handlers(
    recorder: Optional[FlightRecorder] = None,
    directory: Optional[str] = None,
    signum: Optional[int] = None,
    install_excepthook: bool = True,
    install_signal: bool = True,
) -> CrashHandles:
    """Arm the two dump surfaces:

    - `sys.excepthook`: an unhandled exception writes the ring to
      ``<dir>/flight-crash-<pid>.jsonl`` before the normal traceback;
    - SIGUSR2 (default; signum overrides): a live snapshot to
      ``<dir>/flight-usr2-<pid>.jsonl``, `faulthandler`'s all-thread
      stacks to ``<dir>/flight-stacks-<pid>.txt`` and a 5 s profile to
      ``<dir>/profile-usr2-<pid>.json`` (profiler.write_signal_snapshot).

    dir defaults to $TF_OPERATOR_FLIGHT_DIR or the temp dir. -> a
    CrashHandles whose uninstall() restores the previous hooks. Signal
    installation needs the main thread; callers off it pass
    install_signal=False."""
    rec = recorder if recorder is not None else _default
    directory = directory or _dump_dir()
    handles = CrashHandles()

    def write_dump(tag: str) -> Optional[str]:
        path = os.path.join(directory, f"flight-{tag}-{os.getpid()}.jsonl")
        try:
            # crash_dump, not dump: both callers can fire while THIS
            # thread holds the ring lock
            rec.crash_dump(path)
        except OSError:
            return None
        handles.dumps.append(path)
        return path

    if install_excepthook:
        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            path = write_dump("crash")
            if path is not None:
                try:
                    sys.stderr.write(f"flight recorder dump: {path}\n")
                except OSError:
                    pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        def restore_hook(prev=prev_hook):
            sys.excepthook = prev

        handles._add_restore(restore_hook)

    if install_signal:
        import signal as signal_mod

        if signum is None:
            signum = getattr(signal_mod, "SIGUSR2", None)
        if signum is not None:
            def on_signal(sig, frame):
                stacks = os.path.join(directory, f"flight-stacks-{os.getpid()}.txt")
                try:
                    with open(stacks, "w") as f:
                        faulthandler.dump_traceback(file=f, all_threads=True)
                    handles.dumps.append(stacks)
                except OSError:
                    pass
                write_dump("usr2")
                # one signal answers both "what happened" (the dump) and
                # "what is it doing" (a 5 s profile): the snapshot only
                # starts a daemon capture thread, so nothing here blocks
                # or takes a lock the interrupted thread could hold
                from .profiler import write_signal_snapshot

                try:
                    handles.dumps.append(write_signal_snapshot(directory))
                except Exception:  # noqa: BLE001 — diagnostics must never
                    # crash the process they observe
                    pass

            prev_handler = signal_mod.signal(signum, on_signal)

            def restore_signal(sig=signum, prev=prev_handler):
                signal_mod.signal(sig, prev)

            handles._add_restore(restore_signal)

    return handles


def all_thread_stacks() -> str:
    """faulthandler's all-thread dump as a string."""
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


def render_flightz(recorder: FlightRecorder, query: str = "") -> bytes:
    """The /debug/flightz page: JSONL, one record per line, filtered by
    query-string params: `corr=` (alias `request=`) on the correlation
    id, `job=` on job-identifying fields or the corr, `kind=` on the
    record kind, `trace=` on the trace id in fields, `since=<unix_ts>`
    keeps records whose wall clock is at or after it, `limit=` keeps the
    newest N."""
    from urllib.parse import parse_qs

    params = parse_qs(query or "", keep_blank_values=False)

    def first(name: str) -> Optional[str]:
        values = params.get(name)
        return values[0] if values else None

    def number(name: str, cast):
        raw = first(name)
        if not raw:
            return None
        try:
            return cast(raw)
        except ValueError:
            return None

    job = first("job")
    trace = first("trace")
    since = number("since", float)
    limit = number("limit", int)
    records = recorder.snapshot(kind=first("kind"), corr=first("corr") or first("request"))
    if trace is not None:
        records = [r for r in records if r.fields.get("trace") == trace]
    if since is not None:
        records = [r for r in records if r.wall >= since]
    if job is not None:
        records = [
            r for r in records
            if r.corr == job or job in (r.fields.get("job"), r.fields.get("key"),
                                        r.fields.get("obj"))
        ]
    if limit is not None:
        records = records[-max(1, limit):]
    if not records:
        return b""
    return ("\n".join(json.dumps(r.to_dict()) for r in records) + "\n").encode()


# -- Perfetto export ---------------------------------------------------------

def flight_chrome_events(
    records: Iterable, pid: int = 0, tid_base: int = 10_000
) -> List[dict]:
    """Flight records as Chrome/Perfetto instant events: one track per
    correlation id (uncorrelated records share track tid_base), so a
    request's records line up next to its span from the tracer's export.
    Takes FlightRecords or to_dict() dicts (the CLI feeds parsed JSONL)."""
    tracks: Dict[str, int] = {}
    events: List[dict] = []
    for r in records:
        if isinstance(r, FlightRecord):
            r = r.to_dict()
        corr = r.get("corr")
        if corr is None:
            tid = tid_base
        else:
            tid = tracks.setdefault(str(corr), tid_base + 1 + len(tracks))
        fields = dict(r.get("fields") or {})
        if corr is not None:
            fields["corr"] = corr
        name = r.get("kind", "record")
        op = fields.get("op")
        if op:
            name = f"{name}:{op}"
        events.append({
            "name": name,
            "cat": "flight",
            "ph": "i",
            "ts": round(float(r.get("t", 0.0)) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "s": "t",
            "args": fields,
        })
    meta = [{
        "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": f"flight:{corr}"},
    } for corr, tid in tracks.items()]
    return meta + events
