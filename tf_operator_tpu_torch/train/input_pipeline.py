"""Host input pipeline: background batch preparation and placement.
Counterpart of tf_operator_tpu/train/input_pipeline.py.

- A producer thread draws each host batch (the source) and places it on
  the trainer's device while the consumer runs the previous step, up to
  `depth` batches ahead (2: classic double buffering).
- On a CUDA device the placement is an asynchronous copy from pinned
  host memory on a side stream of the pipeline's own. Each placed batch
  carries an event recorded after its copy: the consumer's stream waits
  on that event (the copy of that batch, not the later ones queued
  behind it), and `record_stream` marks the batch's memory as used by
  the consumer's stream, so the caching allocator does not hand it out
  again while a step still reads it.
- The producer's errors reach the consumer at the next `next()`, and
  `close()` (or leaving the `with` block) stops the thread.

Usage:
    with InputPipeline(source=my_batch_fn, trainer=trainer, depth=2) as pipe:
        for batch in pipe:          # batches already on the device
            state, metrics = trainer.step(state, batch)
"""

from __future__ import annotations

import os
import queue
import threading
import time
import zipfile
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

HostBatch = Dict[str, object]


class InputPipeline:
    """Wrap a host batch source into a device-fed iterator.

    source: callable (step index) -> host batch (a dict of tensors or
    numpy arrays), or an iterator of host batches.
    trainer: the Trainer whose `place_batch` places the batch (with its
    packed-mask handling) on its device.
    depth: how many prepared and placed batches may be in flight.
    steps: stop after this many batches (None: until the source ends).
    `host_seconds` is the producer's time in the source and in placing.
    """

    def __init__(self, source, trainer, depth: int = 2, steps: Optional[int] = None) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.trainer = trainer
        self.depth = depth
        self.steps = steps
        self.host_seconds = 0.0
        if callable(source) and not hasattr(source, "__next__"):
            self._next_host = _counted(source)
        else:
            iterator = iter(source)
            self._next_host = lambda: next(iterator)
        device = trainer.device
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._feed, name="input-pipeline", daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------

    def _place(self, host_batch: HostBatch):
        """(placed batch, event after its copy or None)."""
        batch = {k: torch.as_tensor(v) for k, v in host_batch.items()}
        if not self._cuda:
            return self.trainer.place_batch(batch), None
        batch = {k: v.pin_memory() for k, v in batch.items()}
        with torch.cuda.device(self.trainer.device), torch.cuda.stream(self._stream):
            placed = self.trainer.place_batch(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _feed(self) -> None:
        produced = 0
        try:
            while not self._stop.is_set():
                if self.steps is not None and produced >= self.steps:
                    break
                start = time.monotonic()
                host_batch = self._next_host()
                if host_batch is None:
                    break
                item = self._place(host_batch)
                self.host_seconds += time.monotonic() - start
                produced += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except StopIteration:
            pass
        except BaseException as err:  # surfaced on the consumer side
            self._error = err
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer ----------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            # the sentinel was consumed (exhaustion, producer error or
            # close()): keep raising instead of blocking on an empty queue
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                error, self._error = self._error, None
                raise error
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.trainer.device)
            current.wait_event(event)
            for tensor in batch.values():
                tensor.record_stream(current)
        return batch

    def close(self) -> None:
        self._stop.set()
        self._done = True
        try:  # unblock a producer stuck on a full queue
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "InputPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_SENTINEL = object()


def _counted(fn: Callable[[int], HostBatch]) -> Callable[[], Optional[HostBatch]]:
    state = {"i": 0}

    def nxt():
        batch = fn(state["i"])
        state["i"] += 1
        return batch

    return nxt


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of step `step` of a stream seeded with `seed`: a
    function of the pair, as the reference's fold_in(PRNGKey(seed), step)
    (numpy's SeedSequence mixes the two into one 64-bit seed)."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def synthetic_source(make_batch: Callable[[torch.Generator], HostBatch], seed: int = 0):
    """Infinite host-batch source from a seeded synthetic generator
    (models.*.synthetic_batch partials): step i's batch is drawn from
    step_generator(seed, i), so batches differ from step to step and each
    is a function of (seed, step)."""

    def source(step: int) -> HostBatch:
        return make_batch(step_generator(seed, step))

    return source


def shard_source(
    directory,
    batch_size: int,
    shuffle_seed: Optional[int] = 0,
    epochs: Optional[int] = None,
    process_id: int = 0,
    num_processes: int = 1,
    drop_remainder: bool = True,
):
    """Host-batch source over on-disk .npz shards, the file-backed
    counterpart of synthetic_source.

    Layout: `directory/*.npz`, each file a dict of equal-leading-dim
    arrays (e.g. {"image": [n, ...], "label": [n]}); write them with
    `write_shards`. Several processes partition the shards round-robin by
    (process_id, num_processes) and, with drop_remainder, each truncates
    an epoch to the fewest batches any of them has, so every process
    issues the same number of steps. Shard order reshuffles every epoch
    from shuffle_seed; epochs=None streams forever. Batches may span
    shard boundaries, never epochs; with drop_remainder a final short
    batch is dropped (static shapes).
    """
    all_paths = sorted(
        os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".npz")
    )
    paths = all_paths[process_id::num_processes]
    if not paths:
        raise FileNotFoundError(
            f"no .npz shards for process {process_id}/{num_processes} in {directory}"
        )
    per_epoch = None
    if num_processes > 1 and drop_remainder:
        totals = [
            sum(_shard_len(p) for p in all_paths[proc::num_processes])
            for proc in range(num_processes)
        ]
        per_epoch = min(total // batch_size for total in totals)

    def batches():
        epoch = 0
        while epochs is None or epoch < epochs:
            order = list(paths)
            if shuffle_seed is not None:
                np.random.RandomState(shuffle_seed + epoch).shuffle(order)
            pending: Optional[dict] = None
            yielded = 0
            for path in order:
                with np.load(path) as data:
                    arrays = {key: data[key] for key in data.files}
                if pending is not None:
                    arrays = {key: np.concatenate([pending[key], arrays[key]]) for key in arrays}
                    pending = None
                n = len(next(iter(arrays.values())))
                start = 0
                while n - start >= batch_size:
                    if per_epoch is not None and yielded >= per_epoch:
                        break
                    yield {key: value[start:start + batch_size] for key, value in arrays.items()}
                    yielded += 1
                    start += batch_size
                if start < n:
                    pending = {key: value[start:] for key, value in arrays.items()}
            if pending is not None and not drop_remainder:
                yield pending
            epoch += 1

    return batches()


def _shard_len(path) -> int:
    """Leading-dim length of the first array in an .npz, read from the
    npy header only."""
    with zipfile.ZipFile(path) as zf:
        name = sorted(zf.namelist())[0]
        with zf.open(name) as handle:
            version = np.lib.format.read_magic(handle)
            reader = (
                np.lib.format.read_array_header_1_0
                if version == (1, 0)
                else np.lib.format.read_array_header_2_0
            )
            shape, _, _ = reader(handle)
            return shape[0]


def write_shards(directory, arrays: dict, shard_size: int, prefix: str = "shard") -> int:
    """Split a dict of equal-leading-dim arrays into .npz shard files
    consumable by shard_source; returns the shard count."""
    os.makedirs(directory, exist_ok=True)
    total = len(next(iter(arrays.values())))
    count = 0
    for start in range(0, total, shard_size):
        np.savez(
            os.path.join(directory, f"{prefix}-{count:05d}.npz"),
            **{k: v[start:start + shard_size] for k, v in arrays.items()},
        )
        count += 1
    return count
