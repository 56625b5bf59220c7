"""One-off check of the sampling profiler's duty cycle (not collected by
pytest): what the clocks that charge a sampler tick resolve and cost,
what one tick costs with few and with many threads alive, and the
observe smoke's duty-cycle reading run after run, in one process, for
the sampler as the package has it ("repaired": every stack walked whole
each tick, no frame held past it, a tick charged its wall time on the
monotonic clock), with the last tick's stacks held to the next one
(`held_sampler`, the refused tree's tick) or only each thread's leaf
frame (`leaf_held`), as the refused tree had it (`old_meter`: the held
tick charged the thread CPU clock's advance, a system call on each side)
and as it was before (`parent_sampler`: every stack folded anew each
tick, every frame's name formatted anew, the garbage collector free to
run inside a tick, on the old meter), the variants taken in turn within
each repetition, first with the smoke's own threads and then with idle
threads planted beside them (the threads that earlier phases of a long
process could leave alive). --after-groups first runs some of
chip_smoke.py's phase groups in the process, which ages it as the whole
script's process is aged when its observe group runs.

    python tests/torch_duty_cycle_check.py --device cuda --reps 3

--null N first runs N smokes with a tick that samples nothing, on each
meter; --breakdown N then times the parts of a tick over N smokes on
each meter. Prints one
JSON line per reading; exit 0.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def granularity(clock, spin_s: float = 0.2) -> dict:
    """The smallest nonzero step of `clock` seen while this thread spins
    for spin_s of wall time, and how many distinct values it took."""
    seen, steps = set(), []
    end = time.perf_counter() + spin_s
    last = clock()
    while time.perf_counter() < end:
        now = clock()
        if now != last:
            steps.append(now - last)
            seen.add(now)
            last = now
    return {"min_step": min(steps) if steps else None, "values": len(seen)}


def call_us(clock, calls: int = 20000) -> float:
    """Microseconds one call of `clock` takes, on a process at rest."""
    start = time.perf_counter()
    for _ in range(calls):
        clock()
    return (time.perf_counter() - start) * 1e6 / calls


def thread_rusage() -> float:
    usage = resource.getrusage(resource.RUSAGE_THREAD)
    return usage.ru_utime + usage.ru_stime


def schedstat_seconds() -> float:
    with open("/proc/thread-self/schedstat") as f:
        return int(f.read().split()[0]) * 1e-9


def clocks() -> dict:
    out = {name: vars(time.get_clock_info(name)) for name in (
        "thread_time", "process_time", "perf_counter", "monotonic")}
    out["call_us"] = {name: call_us(getattr(time, name)) for name in (
        "monotonic", "time", "perf_counter", "thread_time")}
    out["thread_time_steps"] = granularity(time.thread_time)
    out["process_time_steps"] = granularity(time.process_time)
    out["rusage_thread_steps"] = granularity(thread_rusage)
    try:
        out["schedstat_steps"] = granularity(schedstat_seconds)
    except OSError as err:
        out["schedstat_steps"] = repr(err)
    return out


def plant_threads(count: int, depth: int = 40) -> threading.Event:
    """`count` idle daemon threads, each parked `depth` frames deep."""
    release = threading.Event()

    def park(level: int) -> None:
        if level:
            park(level - 1)
        else:
            release.wait()

    for i in range(count):
        threading.Thread(target=park, args=(depth,), name=f"planted-{i}", daemon=True).start()
    return release


def tick_cost(calls: int = 2000, paced: int = 300) -> dict:
    """One SamplingProfiler tick (_sample_once) timed on this thread:
    wall and thread CPU time a tick, with the threads alive now, back to
    back (`calls`) and paced at the sampler's 99 Hz (`paced`: each tick
    after a sleep, as the sampler's are)."""
    from tf_operator_tpu_torch.telemetry.profiler import DEFAULT_HZ, SamplingProfiler

    profiler = SamplingProfiler()
    out = {"threads": threading.active_count()}
    for label, count, pause in (("hot", calls, 0.0), ("paced", paced, 1.0 / DEFAULT_HZ)):
        wall = cpu = 0.0
        for _ in range(count):
            if pause:
                time.sleep(pause)
            wall0, cpu0 = time.perf_counter(), time.thread_time()
            profiler._sample_once()
            wall += time.perf_counter() - wall0
            cpu += time.thread_time() - cpu0
        out[label] = {"wall_us": wall * 1e6 / count, "thread_time_us": cpu * 1e6 / count}
    return out


def parent_sampler(profiler_cls) -> None:
    """The sampler as it was before this check's repairs: every tick
    folds every stack anew, names every thread, builds each sample
    through ProfileSample's constructor, and lets a collection of the
    cyclic garbage collector run inside a tick (its deferral is turned
    off through the module's view of `gc`)."""
    import types

    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib

    profiler_lib.gc = types.SimpleNamespace(isenabled=lambda: False)

    def fold(frame, limit: int = profiler_lib.MAX_STACK_DEPTH) -> str:
        parts = []
        while frame is not None and len(parts) < limit:
            code = frame.f_code
            parts.append(f"{code.co_filename.rsplit(os.sep, 1)[-1]}:{code.co_name}")
            frame = frame.f_back
        parts.reverse()
        return ";".join(parts)

    def sample_once(self) -> int:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        t, wall = time.monotonic(), time.time()
        folded = [(self._role_of(names.get(ident) or f"thread-{ident}"), fold(frame))
                  for ident, frame in frames.items() if ident != me]
        with self._lock:
            for role, stack in folded:
                seq = self._seq
                self._seq = seq + 1
                self._buf[seq % self.capacity] = profiler_lib.ProfileSample(
                    seq, t, wall, role, stack)
        return len(folded)

    profiler_cls._sample_once = sample_once


def held_sampler(profiler_cls) -> None:
    """The tick as the refused tree had it (this check's first repair):
    each thread's whole stack of the last tick held to the next one, a
    changed stack walked only up to the first frame it shares with it,
    so a frame its thread has left since is freed by the sampler, with
    its locals."""
    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib

    name, limit = profiler_lib._frame_name, profiler_lib.MAX_STACK_DEPTH

    class Stack:
        __slots__ = ("frames", "names", "at", "complete", "fold")

        def __init__(self, frames, names, complete):
            self.frames, self.names, self.complete = frames, names, complete
            self.at = {id(f): i for i, f in enumerate(frames)}
            self.fold = ";".join(names)

    def walk(frame, last):
        if last is not None and last.frames and last.frames[-1] is frame:
            return last
        leaf, new, names = frame, [], []
        while frame is not None and len(new) < limit:
            if last is not None:
                i = last.at.get(id(frame))
                if i is not None and last.frames[i] is frame:
                    new.reverse()
                    names.reverse()
                    frames, joined = last.frames[:i + 1] + new, last.names[:i + 1] + names
                    if len(frames) >= limit:
                        return Stack(frames[-limit:], joined[-limit:], False)
                    if last.complete:
                        return Stack(frames, joined, True)
                    break
            new.append(frame)
            names.append(name(frame.f_code))
            frame = frame.f_back
        else:
            new.reverse()
            names.reverse()
            return Stack(new, names, frame is None)
        return walk(leaf, None)

    def sample_once(self) -> int:
        me = threading.get_ident()
        frames = sys._current_frames()
        t, wall = time.monotonic(), time.time()
        threads = self._threads
        if not frames.keys() <= threads.keys():
            names = {th.ident: th.name for th in threading.enumerate()}
            threads = self._threads = {
                ident: (n, self._role_of(n)) for ident in frames
                for n in (names.get(ident) or f"thread-{ident}",)}
        last, stacks, folded = self.__dict__.get("_held", {}), {}, []
        for ident, frame in frames.items():
            if ident != me:
                stack = stacks[ident] = walk(frame, last.get(ident))
                folded.append((threads[ident][1], stack.fold))
        self._held = stacks
        new = tuple.__new__
        with self._lock:
            for role, fold in folded:
                seq = self._seq
                self._seq = seq + 1
                self._buf[seq % self.capacity] = new(profiler_lib.ProfileSample,
                                                     (seq, t, wall, role, fold))
        return len(folded)

    profiler_cls._sample_once = sample_once


def leaf_held(profiler_cls) -> None:
    """The package's tick, but a thread still in the leaf frame it was
    in at the last tick reuses that tick's fold: each thread's leaf frame
    (not its stack) held to the next tick."""
    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib

    def sample_once(self) -> int:
        frames = sys._current_frames()
        del frames[threading.get_ident()]
        t, wall = time.monotonic(), time.time()
        threads = self._threads
        if not frames.keys() <= threads.keys():
            names = {th.ident: th.name for th in threading.enumerate()}
            threads = self._threads = {
                ident: (n, self._role_of(n)) for ident in frames
                for n in (names.get(ident) or f"thread-{ident}",)}
        leaves = self.__dict__.setdefault("_leaves", {})
        if not leaves.keys() <= frames.keys():
            for ident in leaves.keys() - frames.keys():
                del leaves[ident]
        new = tuple.__new__
        with self._lock:
            seq = self._seq
            for ident, frame in frames.items():
                leaf = leaves.get(ident)
                if leaf is None or leaf[0] is not frame:
                    leaf = leaves[ident] = (frame, profiler_lib._walk(frame, self._folds))
                self._buf[seq % self.capacity] = new(profiler_lib.ProfileSample, (
                    seq, t, wall, threads[ident][1], leaf[1]))
                seq += 1
            self._seq = seq
        return len(frames)

    profiler_cls._sample_once = sample_once


# the ticks' wall seconds of the last smoke run under old_meter
TICK_WALL = {"seconds": None}


def old_meter(profiler_cls) -> None:
    """The loop as the refused tree had it: a tick charged the thread CPU
    clock's advance between a read just before it and one just after (a
    system call each where that clock is not in the vDSO); the ticks'
    wall time kept beside it (TICK_WALL)."""
    import gc as gc_module

    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib

    def loop(self) -> None:
        period, clock = 1.0 / self.hz, time.monotonic
        cpu_clock, stop = profiler_lib.time.thread_time, self._stop_event
        next_t = clock()
        TICK_WALL["seconds"] = 0.0
        while not stop.is_set():
            t0, c0 = clock(), cpu_clock()
            collect = profiler_lib.gc.isenabled()  # the parent's sampler: off
            if collect:
                gc_module.disable()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — as the package's loop
                pass
            finally:
                if collect:
                    gc_module.enable()
            tick = clock() - t0
            self._sample_seconds += cpu_clock() - c0
            TICK_WALL["seconds"] += tick
            self._max_tick_seconds = max(self._max_tick_seconds, tick)
            self._ticks += 1
            next_t += period
            delay = next_t - clock()
            if delay <= 0:
                next_t = clock()
                continue
            stop.wait(delay)

    profiler_cls._loop = loop


def breakdown_probes(profiler_lib) -> dict:
    """Wrap the parts of a tick (the frames snapshot, each stack walked
    anew, the whole tick, and the loop's reads of the thread CPU clock)
    with a wall clock (perf_counter: the thread CPU clock may step in 10
    ms); -> the running sums, in seconds."""
    import types

    sums = {"ticks": 0, "tick": 0.0, "current_frames": 0.0, "walk": 0.0, "walks": 0,
            "renames": 0, "rename": 0.0, "cpu_clock_reads": 0.0}
    clock = time.perf_counter
    walk, once = profiler_lib._walk, profiler_lib.SamplingProfiler._sample_once
    frames_fn = sys._current_frames

    def timed_walk(frame, folds, *rest):
        t0 = clock()
        out = walk(frame, folds, *rest)
        sums["walk"] += clock() - t0
        sums["walks"] += 1
        return out

    def timed_frames():
        t0 = clock()
        out = frames_fn()
        sums["current_frames"] += clock() - t0
        return out

    def timed_once(self):
        t0 = clock()
        out = once(self)
        sums["tick"] += clock() - t0
        sums["ticks"] += 1
        return out

    enumerate_fn = threading.enumerate

    def timed_enumerate():
        t0 = clock()
        out = enumerate_fn()
        sums["rename"] += clock() - t0
        sums["renames"] += 1
        return out

    def timed_thread_time():
        t0 = clock()
        out = time.thread_time()
        sums["cpu_clock_reads"] += clock() - t0
        return out

    profiler_lib._walk = timed_walk
    profiler_lib.SamplingProfiler._sample_once = timed_once
    sys._current_frames = timed_frames
    threading.enumerate = timed_enumerate
    profiler_lib.time = types.SimpleNamespace(
        **{name: getattr(time, name) for name in ("monotonic", "time", "sleep")},
        thread_time=timed_thread_time)

    def undo():
        profiler_lib._walk = walk
        profiler_lib.SamplingProfiler._sample_once = once
        sys._current_frames = frames_fn
        threading.enumerate = enumerate_fn
        profiler_lib.time = time

    sums["undo"] = undo
    return sums


def segmented(profiler_cls, sums: dict) -> None:
    """The package's tick with each part timed on the wall clock into
    `sums` (seconds): the frames snapshot, the stamps and the thread
    names, the walks, the ring's writes; then the same tick again at
    once (`warm`: what the first one paid for its cold start)."""
    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib

    clock, walk = time.perf_counter, profiler_lib._walk

    def once(self) -> int:
        t0 = clock()
        frames = sys._current_frames()
        del frames[threading.get_ident()]
        t1 = clock()
        t, wall = time.monotonic(), time.time()
        threads = self._threads
        if not frames.keys() <= threads.keys():
            names = {th.ident: th.name for th in threading.enumerate()}
            threads = self._threads = {
                ident: (n, self._role_of(n)) for ident in frames
                for n in (names.get(ident) or f"thread-{ident}",)}
        t2 = clock()
        folded = [(threads[ident][1], walk(frame, self._folds))
                  for ident, frame in frames.items()]
        t3 = clock()
        new = tuple.__new__
        with self._lock:
            for role, fold in folded:
                seq = self._seq
                self._seq = seq + 1
                self._buf[seq % self.capacity] = new(profiler_lib.ProfileSample,
                                                     (seq, t, wall, role, fold))
        t4 = clock()
        for key, span in (("frames", t1 - t0), ("names", t2 - t1), ("walks", t3 - t2),
                          ("ring", t4 - t3), ("tick", t4 - t0)):
            sums[key] += span
        return len(folded)

    def twice(self) -> int:
        out = once(self)
        w0 = clock()
        once(self)
        sums["warm"] += clock() - w0
        sums["ticks"] += 1
        return out

    for key in ("frames", "names", "walks", "ring", "tick", "warm"):
        sums[key] = 0.0
    sums["ticks"] = 0
    profiler_cls._sample_once = twice


def smoke(device: str, label: str, rep: int) -> dict:
    from tf_operator_tpu_torch.train import observe

    threads = threading.active_count()
    TICK_WALL["seconds"] = None
    start = time.monotonic()
    try:
        summary = observe.run_train_observe_smoke(device=device)
    except AssertionError as err:
        text = str(err)
        summary = json.loads(text[text.index("{"):])
    stats, wall = summary["profiler_stats"], TICK_WALL["seconds"]
    return {"reading": "smoke", "label": label, "rep": rep, "threads_at_start": threads,
            "duty": summary["profiler_duty_cycle"], **stats,
            "samples_per_tick": summary["profiler_samples"] / max(stats["ticks"], 1),
            "wall_tick_ms": (wall if wall is not None else stats["sample_seconds"]) * 1e3
            / max(stats["ticks"], 1),
            "problems": summary.get("problems", []),
            "seconds": time.monotonic() - start}


def age_process(groups) -> None:
    """Run chip_smoke.py's named phase groups here, as the whole script
    runs them before its observe group (needs the card)."""
    import chip_smoke as c
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.ops import kernels

    kernels.library()
    smi = c.nvidia_smi()
    runs = {"serve": (c.run_serve, (kernels, gpt_lib, smi)),
            "decode_modes": (c.run_decode_modes_phases, (kernels, smi)),
            "moe_vit": (c.run_moe_vit_phases, (kernels, smi))}
    seconds: dict = {}
    for name in groups:
        fn, fn_args = runs[name]
        c.timed_group(seconds, name, fn, *fn_args)
        c.free_device_memory()
    emit({"reading": "aged", "groups": seconds})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--no-planted", action="store_true",
                        help="skip the runs with planted threads")
    parser.add_argument("--planted", type=int, default=30)
    parser.add_argument("--breakdown", type=int, default=0,
                        help="first run this many smokes with each part of a tick timed")
    parser.add_argument("--null", type=int, default=0,
                        help="first run this many smokes with a tick that samples nothing "
                        "(what the loop's wake-ups and clock reads cost alone)")
    parser.add_argument("--segments", type=int, default=0,
                        help="then run this many smokes with each part of a tick timed "
                        "and the tick run twice (the second warm)")
    parser.add_argument("--switch-interval", type=float, default=0.0,
                        help="then one more segmented smoke with the interpreter's GIL "
                        "switch interval set to this (seconds; 0: none)")
    parser.add_argument("--reps-only", default="",
                        help="comma-separated variants to repeat (default: all)")
    parser.add_argument("--after-groups", default="",
                        help="first run these of chip_smoke.py's phase groups in this "
                        "process (comma-separated: serve, decode_modes, moe_vit), so that "
                        "the smokes run in a process aged as the whole script's is")
    args = parser.parse_args(argv)
    if args.after_groups:
        age_process(args.after_groups.split(","))
    from tf_operator_tpu_torch.telemetry import profiler as profiler_lib
    from tf_operator_tpu_torch.telemetry.profiler import SamplingProfiler

    emit({"reading": "clocks", **clocks()})
    original = {name: getattr(SamplingProfiler, name)
                for name in ("_sample_once", "_loop")}

    def install(tick, meter) -> None:
        import gc

        profiler_lib.gc = gc
        for name, fn in original.items():
            setattr(SamplingProfiler, name, fn)
        if tick is not None:
            tick(SamplingProfiler)
        if meter is not None:
            meter(SamplingProfiler)

    def null_tick(cls) -> None:
        cls._sample_once = lambda self: 0

    for rep in range(args.null):
        for meter, label in ((None, "null tick"), (old_meter, "null tick, old meter")):
            install(null_tick, meter)
            emit(smoke(args.device, label, rep))
    for rep in range(args.breakdown):
        for meter, label in ((None, "breakdown"), (old_meter, "breakdown, old meter")):
            install(None, meter)
            sums = breakdown_probes(profiler_lib)
            reading = smoke(args.device, label, rep)
            sums.pop("undo")()
            ticks = max(sums.pop("ticks"), 1)
            emit({**reading, "per_tick_us": {k: v * 1e6 / ticks for k, v in sums.items()
                                              if isinstance(v, float)},
                  "walks_per_tick": sums["walks"] / ticks, "renames_per_tick": sums["renames"] / ticks})
    for rep in range(args.segments + (1 if args.switch_interval else 0)):
        install(None, None)
        sums: dict = {}
        segmented(SamplingProfiler, sums)
        label, interval = "segments", sys.getswitchinterval()
        if rep == args.segments:  # the last, with the GIL's switch interval changed
            label = f"segments, switch interval {args.switch_interval}"
            sys.setswitchinterval(args.switch_interval)
        try:
            reading = smoke(args.device, label, rep)
        finally:
            sys.setswitchinterval(interval)
        ticks = max(sums.pop("ticks"), 1)
        emit({**reading, "per_tick_us": {k: v * 1e6 / ticks for k, v in sums.items()}})
    variants = {
        "repaired": (None, None),
        "held stacks": (held_sampler, None),
        "leaf held": (leaf_held, None),
        "refused": (held_sampler, old_meter),
        "parent": (parent_sampler, old_meter),
    }
    release = None
    for planted in (0,) if args.no_planted else (0, args.planted):
        if planted:
            release = plant_threads(planted)
        for rep in range(-1, args.reps):
            for mode, (tick, meter) in variants.items():
                if args.reps_only and mode not in args.reps_only.split(","):
                    continue
                install(tick, meter)
                label = f"{mode}, planted {planted}"
                if rep < 0:
                    emit({"reading": "tick_cost", "label": label, **tick_cost()})
                else:
                    emit(smoke(args.device, label, rep))
    install(None, None)
    if release is not None:
        release.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
