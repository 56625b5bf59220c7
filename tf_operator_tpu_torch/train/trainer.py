"""The training engine's core. Counterpart of
tf_operator_tpu/train/trainer.py: the state object, `Task`,
`classification_task`, `mlm_task`, `causal_lm_task`, `moe_task`, `warmup_cosine_lr`,
`held_out_eval`, `restore_if_any` and `timed_run` (the token CLIs' loop),
`Trainer` (init, step with gradient accumulation, run_steps, evaluate,
place_batch, fit, save, restore) and `Checkpointer`.

JAX's train state is immutable and each step returns a new one; here
the state holds the model and its optimizer, and `Trainer.step` updates
both in place (no second copy of parameters or moments) and returns the
same object. `state.step` is a host int.

AdamW has optax's semantics: b1 0.9, b2 0.999, eps 1e-8 added outside
the square root, and decoupled weight decay on every parameter in one
group, p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), which is
what torch.optim.AdamW computes. optax.adamw defaults to weight decay
1e-4 and torch to 1e-2: the port defaults to optax's and callers pass
it explicitly. optax.adam is AdamW with weight decay 0.

The reference's Trainer takes any optax transformation; the port takes
`optimizer="adamw"` (the default, as above) or `"sgd"`, optax.sgd(lr,
momentum=0.9) as train/resnet.py builds it: trace = g + 0.9 * trace
from a zero trace, p <- p - lr * trace. That is torch.optim.SGD with
momentum 0.9, dampening 0, no Nesterov and no weight decay, whose first
step's buf = g agrees with the zero start. Both read the learning rate
(or schedule) per step.

BatchNorm running statistics are module buffers: `step` runs the model
in train mode, which updates them in the forward (once per microbatch
under accumulation, as the reference threads `batch_stats` through its
scan), and `evaluate` in eval mode, which reads them.

Several processes (`mesh`, the reference's :190-206): `init` lays the
model over the mesh by the rule set (parallel/sharding.py: DDP, FSDP2
for TRANSFORMER_RULES with fsdp > 1, or the Megatron plan with tp > 1
and DDP over the grad group). As in the reference, a batch is the
GLOBAL batch, the same on every process: `place_batch` keeps this
rank's rows, and with shard_sequence (sp > 1) its sequence shard, so
one global batch gives the same step at any mesh. A weighted loss (mlm,
and the causal LM under sp, weighted by its shard's positions)
normalises by the weight mass of the global batch, the metrics are
those of the global batch, checkpoints hold the full state in the
port's format (gathered under FSDP2 and tp; rank 0 writes, every rank
reads), and a SIGTERM on any rank stops every rank on the same step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..parallel import distributed
from ..parallel import mesh as mesh_lib
from ..parallel import sharding as sharding_lib

logger = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class Task:
    """How to compute loss for a model family: loss_fn(module, batch,
    train) -> (loss, aux metrics), where `module` is what the trainer
    calls: the model, or its data-parallel wrapper. aux["loss_weight"],
    where a task reports it, is the weight mass of the (micro)batch that
    its weighted-mean loss divides by."""

    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


class WarmupCosine:
    """Linear warmup from 0 to `peak` over `warmup_steps`, then cosine
    decay to 10% of it at `decay_steps`: optax.warmup_cosine_decay_schedule.
    Called with a host step count it returns a float; `on_device` takes
    the count as a float64 tensor and computes the same in tensor ops,
    which is how `run_steps`' CUDA graph reads the rate at each replay."""

    def __init__(self, peak: float, warmup_steps: int, decay_steps: int) -> None:
        self.peak = peak
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.end = peak * 0.1

    def __call__(self, count: int) -> float:
        if count < self.warmup_steps:
            return self.peak * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return self.end + (self.peak - self.end) * cosine

    def on_device(self, count: torch.Tensor) -> torch.Tensor:
        span = self.decay_steps - self.warmup_steps
        warm = self.peak * count / self.warmup_steps
        t = torch.clamp(count - self.warmup_steps, max=span)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / span))
        decayed = self.end + (self.peak - self.end) * cosine
        return torch.where(count < self.warmup_steps, warm, decayed)


def warmup_cosine_lr(peak: float, steps: int, warmup_steps: int) -> LearningRate:
    """Constant `peak` when warmup_steps == 0; otherwise WarmupCosine with
    decay_steps clamped to warmup_steps + 1, as the reference clamps it."""
    if not warmup_steps:
        return peak
    return WarmupCosine(peak, warmup_steps, max(steps, warmup_steps + 1))


def classification_task() -> Task:
    """Softmax cross-entropy of f32 logits against integer labels, mean
    over the batch, plus accuracy; the model reads `training` itself."""

    def loss_fn(model: nn.Module, batch: Batch, train: bool = True):
        logits = model(batch["image"]).float()
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": accuracy}

    return Task(loss_fn=loss_fn)


def mlm_task() -> Task:
    """Masked-LM loss, reporting the batch's mlm weight mass as
    "loss_weight" so that accumulation and ranks (dp and sp shards)
    re-weight uneven microbatches and shards to the exact global weighted
    mean (the reference's :96-103). Under tp the head's logits are
    vocab-parallel (parallel/sharding.py vocab_shard)."""
    from ..models.bert import mlm_loss

    def loss_fn(model: nn.Module, batch: Batch, train: bool = True):
        logits = model(batch["input_ids"], batch.get("attention_mask"))
        loss = mlm_loss(logits, batch["labels"], batch["mlm_weights"],
                        sharding_lib.vocab_shard(model))
        return loss, {"loss_weight": batch["mlm_weights"].sum()}

    return Task(loss_fn=loss_fn)


def causal_lm_task() -> Task:
    """Next-token prediction on mask-free token batches (GPT). On a
    sequence shard (the batch holds "next_ids", Trainer.place_batch under
    sp) the loss is the shard's mean with its positions as "loss_weight",
    so the ranks' weighting gives the global mean."""
    from ..models.gpt import causal_lm_loss, sharded_lm_loss

    def loss_fn(model: nn.Module, batch: Batch, train: bool = True):
        vocab = sharding_lib.vocab_shard(model)
        logits = model(batch["input_ids"])
        if "next_ids" in batch:
            loss, count = sharded_lm_loss(logits, batch["next_ids"], vocab)
            return loss, {"loss_weight": count}
        return causal_lm_loss(logits, batch["input_ids"], vocab=vocab), {}

    return Task(loss_fn=loss_fn)


def moe_task() -> Task:
    """Causal LM with the router's losses (models/moe.py): the training
    loss is lm + every router loss, the eval loss lm alone (perplexity
    reads it); under tp the head's logits are vocab-parallel.
    "router_aux" (load balancing) and "router_z" are reported apart;
    "loss_weight" is the mask's weight mass past position 0, so
    accumulation and ranks weight the LM loss exactly (the router terms
    ride the same per-microbatch weighting, as in the reference)."""
    from ..models.moe import lm_loss, sum_sown, total_aux_loss

    def loss_fn(model: nn.Module, batch: Batch, train: bool = True):
        mask = batch.get("attention_mask")
        logits, losses = model(batch["input_ids"], mask)
        lm = lm_loss(logits, batch["labels"], weights=mask,
                     vocab=sharding_lib.vocab_shard(model))
        loss = lm + total_aux_loss(losses) if train else lm
        extras = {"router_aux": sum_sown(losses, "router_aux"),
                  "router_z": sum_sown(losses, "router_z")}
        if mask is not None:
            extras["loss_weight"] = mask[:, 1:].float().sum()
        return loss, extras

    return Task(loss_fn=loss_fn)


HELD_OUT_FOLD = 2**31 - 1
OPTIMIZERS = ("adamw", "sgd")
SGD_MOMENTUM = 0.9
# aux keys that are bookkeeping, not metrics
_NOT_METRICS = ("loss_weight",)


def held_out_eval(
    trainer: "Trainer", state: TrainState,
    make_batch: Callable[[torch.Generator], Batch], seed: int,
) -> Dict[str, float]:
    """End-of-run eval on a batch the training stream never saw: drawn
    from a generator seeded with seed + HELD_OUT_FOLD. Returns the
    task's eval metrics as floats plus 'perplexity' (clamped exp)."""
    generator = torch.Generator().manual_seed(seed + HELD_OUT_FOLD)
    batch = trainer.place_batch(make_batch(generator))
    metrics = {k: float(v) for k, v in trainer.evaluate(state, batch).items()}
    metrics["perplexity"] = math.exp(min(metrics["loss"], 20.0))
    return metrics


def restore_if_any(trainer: "Trainer", state: TrainState) -> TrainState:
    """The CLIs' resume: the newest checkpoint under the trainer's
    checkpoint_dir if there is one, else `state` as it is."""
    if trainer.checkpoint_dir is None:
        return state
    restored = trainer.restore(state)
    if restored is None:
        return state
    logger.info("resumed from step %d", restored.step)
    return restored


def _set_lr(optimizer: torch.optim.Optimizer, lr: Union[float, torch.Tensor]) -> None:
    """Set every group's rate: in place where it is a device scalar
    (Trainer.init on CUDA), so that a captured graph keeps reading it."""
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = lr
        elif isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rate_unit(batch: Batch) -> Tuple[str, Callable[[Batch], int]]:
    """What a timed run's rate counts: tokens (the elements of input_ids)
    in a token batch, else images."""
    if "input_ids" in batch:
        return "tokens", lambda b: b["input_ids"].numel()
    return "images", lambda b: b["image"].shape[0]


def _metric_text(metrics: Dict[str, Any]) -> str:
    """The metrics but loss and perplexity, for a log line: " name=value"
    each."""
    return "".join(f" {name}={float(value):.5f}" for name, value in sorted(metrics.items())
                   if name not in ("loss", "perplexity"))


def timed_run(
    trainer: "Trainer", state: TrainState,
    make_batch: Callable[[torch.Generator], Batch], generator: torch.Generator,
    steps: int, log_every: int, seed: int,
    profile_dir: Optional[str] = None,
    on_step: Optional[Callable[[TrainState], object]] = None,
    reuse_batch: bool = False,
) -> Tuple[TrainState, Dict[str, Any], Batch]:
    """The entry points' loop (train/bert.py, train/gpt.py,
    train/resnet.py), the reference's CLI loop
    (tf_operator_tpu/train/gpt.py:137-200):

    - one eager warm-up step (first launches, allocator growth, kernel
      build) on a batch drawn from `generator`, outside the timed window;
    - `steps` is the TOTAL budget counting steps already in state.step
      (a restored checkpoint) and the warm-up, so a resumed process runs
      the remainder;
    - the timed steps take fresh batches from an InputPipeline over
      synthetic_source(make_batch, seed), drawn and placed in the
      background (from before the warm-up on) while the previous step
      runs; with reuse_batch every step reuses the warm-up's placed batch
      instead (the ResNet CLI, as the reference's: a fresh 224x224 batch
      would set the pace), and there is no held-out eval;
    - the timed steps run under a PreemptionGuard: after a latched
      SIGTERM (on any rank: agree_on_preemption) the step drains, a
      checkpoint is written (when the trainer has a checkpoint_dir) and
      the loop stops with exit code 143;
    - profile_dir traces the first timed steps (telemetry/profiler.py);
    - on_step(state), if given, runs after every optimizer step, the
      warm-up's included.

    Then held_out_eval, unless preempted or reuse_batch. Returns the
    state, the summary and the warm-up step's batch. The summary: the
    warm-up step's and the final train loss, the final step's other
    metrics (router_aux, accuracy, ...) by their names and the warm-up
    step's as first_<name>, `<unit>_per_sec` over the
    timed steps (tokens or images of the global batch), their seconds, the
    host seconds the producer spent drawing and placing their batches
    and the seconds the loop waited for one, held-out eval loss and
    perplexity (and the eval's other metrics as eval_<name>), the number
    of forward and backward passes (microbatches
    under accumulation), the first and the final step, "preempted" and
    the "exit_code" (0 or 143)."""
    from ..telemetry.profiler import StepProfiler
    from .input_pipeline import InputPipeline, synthetic_source
    from .preemption import PreemptionGuard, agree_on_preemption, maybe_preempt_exit

    device = trainer.device
    start_step = state.step
    # the warm-up step below counts toward the budget; the pipeline starts
    # first, so that its first batches are ready when the timed steps begin
    remaining = max(0, steps - state.step - 1)
    profiler = StepProfiler(profile_dir, remaining, window=(0, 5))
    items = steps_run = exit_code = 0
    wait_seconds = batch_seconds = 0.0
    pipe = None
    if not reuse_batch:
        pipe = InputPipeline(
            synthetic_source(make_batch, seed), trainer, depth=2, steps=remaining,
        )
    try:
        first_batch = make_batch(generator)
        unit, count = _rate_unit(first_batch)  # the global batch's items
        placed = trainer.place_batch(first_batch)
        state, metrics = trainer.step(state, placed)
        first_loss = float(metrics["loss"])
        first = {f"first_{name}": float(v) for name, v in metrics.items() if name != "loss"}
        _sync(device)
        if on_step is not None:
            on_step(state)
        trainer.health.set("training")
        start = time.monotonic()
        with PreemptionGuard() as guard:
            for i in range(remaining):
                batch = placed
                if pipe is not None:
                    waited = time.monotonic()
                    batch = next(pipe)
                    wait_seconds += time.monotonic() - waited
                profiler.before_step(i)
                state, metrics = trainer.step(state, batch)
                profiler.after_step(i, drain=lambda: float(metrics["loss"]))
                steps_run += 1
                items += count(batch) * trainer.grad_shards
                if on_step is not None:
                    on_step(state)
                agree_on_preemption(guard)
                rc = maybe_preempt_exit(guard, trainer, state, trainer.checkpoint_dir)
                if rc is not None:
                    exit_code = rc
                    break
                if (i + 1) % log_every == 0:
                    logger.info("step %d loss=%.4f%s", state.step, float(metrics["loss"]),
                                _metric_text(metrics))
        loss = float(metrics["loss"])
        _sync(device)
        elapsed = time.monotonic() - start
        if pipe is not None:
            batch_seconds = pipe.host_seconds
    finally:
        try:
            profiler.close()
        finally:
            if pipe is not None:
                pipe.close()
    rate = items / elapsed if steps_run else 0.0
    logger.info(
        "%s/sec on %s: %.1f (loss %.4f)", unit,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        rate, loss,
    )
    k = trainer.accum_steps
    summary = {
        **first,
        **{name: float(value) for name, value in metrics.items() if name != "loss"},
        "loss": loss,
        "first_loss": first_loss,
        f"{unit}_per_sec": rate,
        "seconds": elapsed,
        "batch_seconds": batch_seconds,
        "wait_seconds": wait_seconds,
        "steps": steps_run,
        "start_step": start_step,
        "step": state.step,
        "accum_steps": k,
        "world": distributed.world_size(),
        "forward_passes": (1 + steps_run) * k,  # warmup + steps, per microbatch
        "backward_passes": (1 + steps_run) * k,
        "preempted": float(exit_code != 0),
        "exit_code": exit_code,
    }
    if profiler.trace_path is not None:
        summary["trace_path"] = profiler.trace_path
    if exit_code or reuse_batch:
        return state, summary, first_batch
    ev = held_out_eval(trainer, state, make_batch, seed)
    logger.info("eval loss %.4f (ppl %.1f)%s", ev["loss"], ev["perplexity"], _metric_text(ev))
    summary.update({f"eval_{name}": value for name, value in ev.items()})
    summary["forward_passes"] += 1  # the eval's
    return state, summary, first_batch


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        task: Task,
        learning_rate: LearningRate = 1e-4,
        weight_decay: float = 1e-4,
        packed: bool = False,
        device: Optional[Union[str, torch.device]] = None,
        optimizer: str = "adamw",
        checkpoint_dir: Optional[str] = None,
        accum_steps: int = 1,
        metrics_registry=None,
        clock=None,
        phase_flight_every: int = 50,
        mesh=None,
        rules: sharding_lib.WrapPlan = sharding_lib.TRANSFORMER_RULES,
        shard_sequence: bool = False,
    ) -> None:
        """mesh: parallel/mesh.py build_mesh's TrainMesh over the world,
        or None for one process (the model runs unwrapped); rules: the
        wrap plan (parallel/sharding.py), TRANSFORMER_RULES by default as
        in the reference; shard_sequence: each rank keeps its sp shard of
        the sequence (the model's attention_fn is then ring or Ulysses
        attention over the mesh); phase_flight_every: the step phase
        timer writes one kind="trainstep" flight record every that many
        steps."""
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} not in {OPTIMIZERS}")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.optimizer = optimizer
        self.model = model
        # what the task calls: the model, or its DDP wrapper after init
        self.module: nn.Module = model
        self.mesh = mesh
        self.rules = rules
        self.shard_sequence = shard_sequence
        self.data_shards = mesh_lib.data_shards(mesh)
        # the ranks that hold distinct tokens of a batch, whose gradients
        # and metrics are reduced together (dp x fsdp x sp)
        self.grad_shards = mesh_lib.grad_shards(mesh)
        self._grad_group = None if mesh is None else mesh.grad_group
        self.task = task
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.packed = packed
        self.device = resolve_device(device)
        # gradient accumulation: each step splits the batch into this many
        # microbatches and applies ONE optimizer update (see _forward_backward)
        self.accum_steps = accum_steps
        self.checkpoint_dir = checkpoint_dir
        self._ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir is not None else None
        # run_steps' captured steps, by batch signature; dropped whenever the
        # optimizer's state tensors are replaced (init, restore)
        self._graphs: Dict[Tuple, "_CapturedStep"] = {}
        self.last_graph: Optional["_CapturedStep"] = None
        # trainer-plane telemetry on the shared registry, as the reference's
        # (trainer.py:218-264); registration is get-or-create
        from ..controller.clock import Clock
        from ..telemetry import STEP_BUCKETS, default_registry
        from .observe import GoodputLedger, HealthPhase, StepPhaseTimer

        registry = metrics_registry if metrics_registry is not None else default_registry()
        self.metrics_registry = registry
        self._h_step_seconds = registry.histogram(
            "train_step_seconds",
            "Wall-clock time per optimizer step (the first observation "
            "absorbs the warm-up)",
            buckets=STEP_BUCKETS,
        )
        self._g_tokens_per_sec = registry.gauge(
            "train_tokens_per_sec",
            "Training token throughput over the last logging interval",
        )
        self._c_steps = registry.counter(
            "train_steps_total", "Optimizer steps executed by this process",
        )
        self.clock = clock if clock is not None else Clock()
        self.phase_timer = StepPhaseTimer(registry, clock=self.clock,
                                          flight_every=phase_flight_every)
        self.goodput = GoodputLedger(registry)
        self.health = HealthPhase()
        # step of the newest durable checkpoint (what a restart resumes
        # from): the preemption-lost tail is measured against it
        self._last_saved_step = 0
        self._last_save_mono: Optional[float] = None

    def _prepare_batch(self, batch: Batch) -> Batch:
        """Packed (unpadded) training, and sequence-parallel training
        (whose attentions refuse a mask): the all-ones mask is pure
        overhead even for the in-kernel mask path, so it is dropped
        here, at the mechanism."""
        if (self.packed or self.shard_sequence) and "attention_mask" in batch:
            batch = {k: v for k, v in batch.items() if k != "attention_mask"}
        return batch

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self) -> TrainState:
        """Move the model to the trainer's device, lay it over the mesh
        (once; parallel/sharding.py parallelize) and build its optimizer.
        On a CUDA device the learning rate is a device scalar that `step`
        refills and run_steps' graph computes (WarmupCosine.on_device), and
        the optimizer is the form that reads it there: fused AdamW (marked
        capturable, which graph capture asks of it) or fused SGD, one
        kernel over the parameters a step. Eager steps and graph replays
        so run one implementation."""
        self.model.to(self.device)
        if self.mesh is not None and self.module is self.model:
            self.module = sharding_lib.parallelize(self.model, self.mesh, self.rules, self.device)
        self._graphs.clear()
        cuda = self.device.type == "cuda"
        lr = self._lr(0)
        if cuda:
            lr = torch.tensor(float(lr), dtype=torch.float32, device=self.device)
        if self.optimizer == "sgd":
            optimizer = torch.optim.SGD(
                self.model.parameters(), lr=lr, momentum=SGD_MOMENTUM,
                dampening=0.0, nesterov=False, weight_decay=0.0, fused=cuda or None,
            )
        else:
            optimizer = torch.optim.AdamW(
                self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=self.weight_decay,
                capturable=cuda, fused=cuda or None,
            )
        return TrainState(step=0, model=self.model, optimizer=optimizer)

    def place_batch(self, batch: Batch) -> Batch:
        """This rank's rows of the global `batch`, on the device. With a
        mesh, rank r of n keeps, of each of the accum_steps microbatches,
        its r-th of n row ranges, so that microbatch i over all ranks is
        the reference's microbatch i (rows i*B/k to (i+1)*B/k). With
        shard_sequence it keeps its sp shard [start, stop) of every
        [rows, seq] value, and "next_ids", the input ids at [start + 1,
        stop + 1) of the full rows (one fewer on the last shard), for the
        causal LM's labels."""
        batch = {k: self._local_rows(torch.as_tensor(v))
                 for k, v in self._prepare_batch(batch).items()}
        if self.shard_sequence:
            ids = batch.get("input_ids")
            span = mesh_lib.local_positions(self.mesh, next(iter(batch.values())).shape[1])
            batch = {k: v[:, span] for k, v in batch.items()}
            if ids is not None:
                batch["next_ids"] = ids[:, span.start + 1:span.stop + 1]
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def _local_rows(self, value: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return value
        k = self.accum_steps
        if value.shape[0] % k:
            raise ValueError(
                f"global batch {value.shape[0]} is not divisible by accum_steps {k}")
        micro = value.reshape(k, value.shape[0] // k, *value.shape[1:])
        rows = mesh_lib.local_rows(self.mesh, micro.shape[1])
        return micro[:, rows].reshape(-1, *value.shape[1:])

    def _forward_backward(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss and gradients of `batch` into the parameters' .grad
        (accumulated onto what is there); returns the detached loss and
        the task's metrics.

        With accum_steps = k > 1 the batch is split into k microbatches
        along dim 0 (a batch not divisible by k raises). Each backpropagates
        w_i * loss_i, w_i = aux["loss_weight"] where the task reports it
        and 1 otherwise, and frees its graph before the next runs, so
        activation memory is one microbatch's. The summed gradient is then
        divided by sum(w_i) and the loss reported is sum(w_i * loss_i) /
        sum(w_i): the full-batch weighted mean, as the reference's scan
        accumulates it (trainer.py:332-467). Other metrics are the mean
        over microbatches.

        With a mesh, the backward passes of all microbatches but the last
        keep their gradients local (sharding.no_grad_sync), and the last
        one's reduce averages them over the n ranks. A task's weight is
        normalised over the GLOBAL batch: at k = 1 the loss backpropagated
        is loss * w_r * n / W (W the all-reduced weight mass, detached), at
        k > 1 the gradients are divided by W / n, so that the average over
        the ranks is sum(w * g) / W, not a mean of per-rank means. The
        loss and metrics returned are the global batch's (_global_metrics).
        In a single process nothing of this runs."""
        k = self.accum_steps
        if k == 1:
            loss, aux = self.task.loss_fn(self.module, batch, train=True)
            share = self._weight_share(aux.get("loss_weight"))
            if share is not None:
                loss = loss * share
            loss.backward()
            metrics = {n: v.detach() for n, v in aux.items() if n not in _NOT_METRICS}
            return self._global_metrics(loss.detach(), metrics)
        leading = next(iter(batch.values())).shape[0]
        if leading % k:
            raise ValueError(f"global batch {leading} is not divisible by accum_steps {k}")
        parts = {name: value.chunk(k) for name, value in batch.items()}
        loss_sum = weight_sum = None
        weighted_task = False
        metric_sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
            with sharding_lib.no_grad_sync(self.module) if i < k - 1 else contextlib.nullcontext():
                loss, aux = self.task.loss_fn(
                    self.module, {name: p[i] for name, p in parts.items()}, train=True)
                weight = aux.get("loss_weight")
                weighted = loss if weight is None else weight.detach().float() * loss
                weighted.backward()
            weighted_task = weight is not None
            weight = torch.ones_like(loss.detach()) if weight is None else weight.detach().float()
            loss_sum = weighted.detach() if loss_sum is None else loss_sum + weighted.detach()
            weight_sum = weight if weight_sum is None else weight_sum + weight
            for name, value in aux.items():
                if name not in _NOT_METRICS:
                    metric_sums[name] = metric_sums.get(name, 0) + value.detach()
        if weighted_task and self.grad_shards > 1:
            # W / n: the ranks' average of sum(w * g) / (W / n) is sum(w * g) / W
            weight_sum = self._all_reduce(weight_sum) / self.grad_shards
        for param in self.model.parameters():
            if param.grad is not None:
                sharding_lib.local_tensor(param.grad).div_(weight_sum)
        metrics = {name: value / k for name, value in metric_sums.items()}
        return self._global_metrics(loss_sum / weight_sum, metrics)

    def _all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """A sum over the grad group (the ranks holding distinct tokens)."""
        tensor = tensor.clone()
        dist.all_reduce(tensor, group=self._grad_group)
        return tensor

    def _weight_share(self, weight: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """w_r * n / W for this rank's weight mass w_r (one all-reduce), or
        None in a single process or for a task without weights."""
        if weight is None or self.grad_shards == 1:
            return None
        weight = weight.detach().float()
        return weight * self.grad_shards / self._all_reduce(weight)

    def _global_metrics(
        self, loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss (already weighted by _weight_share where the task has
        weights) and metrics averaged over the ranks, in one all-reduce."""
        if self.grad_shards == 1:
            return loss, metrics
        names = sorted(metrics)
        packed = torch.stack([loss.float()] + [metrics[n].float() for n in names])
        packed = self._all_reduce(packed) / self.grad_shards
        return packed[0], dict(zip(names, packed[1:]))

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on `batch` (as place_batch returns it).
        Updates the state in place and returns it with the step's
        metrics as device tensors; reading them waits for the device."""
        self.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._forward_backward(batch)
        _set_lr(state.optimizer, self._lr(state.step))
        state.optimizer.step()
        state.step += 1
        self._c_steps.inc()
        metrics["loss"] = loss
        return state, metrics

    def run_steps(
        self, state: TrainState, batch: Batch, n: int,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """n optimizer steps on one placed batch; returns the state after n
        steps and the last step's metrics (the reference's :480-565, which
        fuses n steps into one dispatch).

        On a CUDA device the step is a CUDA graph (_CapturedStep): zero the
        grads in place, forward, backward and the optimizer update,
        captured once per batch signature after an eager warm-up step on a
        side stream, then replayed on a static copy of the batch. The first
        call for a signature runs that warm-up as the first of its n steps.
        The learning rate inside the graph comes from a device-side step
        counter (WarmupCosine.on_device), so the schedule advances at every
        replay, and the optimizer is the eager steps' own (see
        _CapturedStep). A capture that fails raises: there is no eager
        fallback. On the CPU, where the caller asked for it, and with a mesh
        (any world size: the step's collectives are not captured), this is
        n `step` calls."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self.device.type != "cuda" or self.mesh is not None:
            for _ in range(n):
                state, metrics = self.step(state, batch)
            return state, metrics
        key = tuple((name, tuple(v.shape), v.dtype) for name, v in sorted(batch.items()))
        graph = self._graphs.get(key)
        replays = n
        metrics = None
        if graph is None:
            graph = _CapturedStep(self, batch)
            state, metrics = graph.warm_up_and_capture(self, state, batch)
            self._graphs[key] = graph
            replays -= 1
        self.last_graph = graph
        if replays:
            metrics = graph.replay(state, batch, replays)
            state.step += replays
            self._c_steps.inc(replays)
        return state, metrics

    @torch.no_grad()
    def evaluate(self, state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        """One no-gradient pass; returns the task's metrics and loss, those
        of the global batch under a mesh (every rank must call it)."""
        self.module.eval()
        loss, aux = self.task.loss_fn(self.module, self._prepare_batch(batch), train=False)
        share = self._weight_share(aux.get("loss_weight"))
        metrics = {n: v for n, v in aux.items() if n not in _NOT_METRICS}
        loss, metrics = self._global_metrics(loss if share is None else loss * share, metrics)
        metrics["loss"] = loss
        return metrics

    # -- the fit loop -------------------------------------------------------

    def _account_step(self, i: int, start_step: int, state: TrainState, ckpt_seconds: float) -> None:
        """Close the phase timer for loop iteration `i` and attribute its
        wall to the goodput ledger: iteration 0 is warm-up (re-warm-up when
        resumed from a checkpoint), checkpoint seconds are waste, the rest
        useful. Every executed step lands in exactly one integer bucket
        (useful/warmup/rewarmup), so the ledger reconciles exactly with the
        step counter. state.step is a host int, so the device is
        synchronised here: the device time of the step lands in its own
        device_sync lap, not in the next step's."""
        _sync(self.device)
        self.phase_timer.lap("device_sync")
        split = self.phase_timer.finish(state.step)
        productive = max(split.get("wall", 0.0) - ckpt_seconds, 0.0)
        if ckpt_seconds > 0:
            self.goodput.waste("checkpoint", ckpt_seconds)
        if i == 0:
            self.goodput.waste("warmup" if start_step == 0 else "rewarmup", productive, steps=1)
        else:
            self.goodput.useful(productive, steps=1)

    def fit(
        self,
        state: TrainState,
        batches: Iterator[Batch],
        steps: int,
        log_every: int = 50,
        checkpoint_every: Optional[int] = None,
        metrics_callback: Optional[Callable[[int, Dict[str, float]], object]] = None,
        profile_dir: Optional[str] = None,
        profile_window: Tuple[int, int] = (3, 8),
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Run up to `steps` TOTAL optimizer steps (the reference's
        :597-785): steps already in state.step (a restored checkpoint)
        count toward the budget, so a preempted and restarted job converges
        on `steps` instead of running a full budget per restart.

        Each step is lapped into the phase timer and the goodput ledger.
        metrics_callback(step, metrics) fires on every logging interval and
        at a preemption. checkpoint_every saves asynchronously every that
        many steps; the finally block settles any save in flight, also on
        an aborted run. profile_dir traces profile_window's [start, stop)
        steps (telemetry/profiler.py), skipping the warm-up step.

        SIGTERM is latched (train/preemption.py): the step in flight
        drains, a blocking checkpoint is written when the trainer has a
        checkpoint_dir, the lost tail since the newest checkpoint is
        accounted as waste, and the returned metrics carry "preempted":
        1.0, so the CLI exits with the retryable code 143. With a mesh a
        SIGTERM on any rank stops every rank on the same step
        (agree_on_preemption), and every rank calls save."""
        from ..telemetry.flight import flight_record
        from ..telemetry.profiler import StepProfiler
        from .preemption import PreemptionGuard, agree_on_preemption, record_preemption

        last_metrics: Dict[str, float] = {}
        interval_start = self.clock.monotonic()
        interval_steps = 0
        start_step = state.step
        remaining = max(0, steps - start_step)
        if remaining < steps:
            logger.info("step budget %d: resumed at %d, running %d more",
                        steps, start_step, remaining)
        profiler = StepProfiler(profile_dir, remaining, profile_window)
        guard = PreemptionGuard()
        timer = self.phase_timer
        self.health.set("warming")
        self._last_saved_step = max(self._last_saved_step, start_step)
        try:
            guard.__enter__()
            for i in range(remaining):
                ckpt_seconds = 0.0
                timer.start()
                profiler.before_step(i)
                batch = next(batches)
                timer.lap("data_wait")
                batch = self.place_batch(batch)
                timer.lap("host_to_device")
                state, metrics = self.step(state, batch)
                # dispatch time, not device time: the card runs behind the
                # host until something waits for it
                self._h_step_seconds.observe(timer.lap("step_dispatch"))
                interval_steps += 1
                profiler.after_step(i, drain=lambda: float(metrics["loss"]))
                timer.lap("device_sync")
                agree_on_preemption(guard)
                if guard.triggered.is_set():
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    last_metrics["preempted"] = 1.0
                    saved = False
                    if self._ckpt is not None:
                        # blocking: the grace period is short and the next
                        # thing this process does is exit
                        self.health.set("checkpointing")
                        self.save(state)
                        ckpt_seconds += timer.lap("checkpoint")
                        saved = True
                        logger.warning("preempted at step %d: checkpoint saved, "
                                       "resume will continue from here", state.step)
                    else:
                        logger.warning("preempted at step %d with NO checkpoint_dir: "
                                       "progress will be lost on restart", state.step)
                    self.health.set("preempted")
                    lost = max(state.step - self._last_saved_step, 0)
                    if lost > 0:
                        avg = timer.wall_seconds / timer.steps if timer.steps else 0.0
                        self.goodput.waste("preempted", lost * avg, steps=lost)
                    record_preemption(self, state, saved=saved)
                    if metrics_callback is not None:
                        metrics_callback(state.step, dict(last_metrics))
                    self._account_step(i, start_step, state, ckpt_seconds)
                    break
                if checkpoint_every and (i + 1) % checkpoint_every == 0:
                    # async: the write overlaps the next steps' compute
                    self.health.set("checkpointing")
                    self.save(state, block=False)
                    ckpt_seconds += timer.lap("checkpoint")
                    self.health.set("training")
                if (i + 1) % log_every == 0 or i + 1 == remaining:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    timer.lap("device_sync")  # the float()s waited for the card
                    now = self.clock.monotonic()
                    last_metrics["steps_per_sec"] = interval_steps / max(now - interval_start, 1e-9)
                    ids = batch.get("input_ids")
                    if ids is not None:
                        self._g_tokens_per_sec.set(last_metrics["steps_per_sec"] * ids.numel())
                    interval_start, interval_steps = now, 0
                    flight_record(
                        "train", op="step-stats", step=state.step,
                        loss=round(last_metrics.get("loss", float("nan")), 6),
                        steps_per_sec=round(last_metrics["steps_per_sec"], 3),
                    )
                    logger.info("step %d loss=%.4f (%.1f steps/s)", state.step,
                                last_metrics.get("loss", float("nan")),
                                last_metrics["steps_per_sec"])
                    if metrics_callback is not None:
                        metrics_callback(state.step, dict(last_metrics))
                    timer.lap("eval_publish")
                self._account_step(i, start_step, state, ckpt_seconds)
                if i == 0:
                    self.health.set("training")
        finally:
            guard.__exit__()
            try:
                profiler.close()
            finally:
                if self._ckpt is not None:
                    # settle any async save so the newest complete checkpoint
                    # is durable even on an aborted run
                    self._ckpt.wait()
        return state, last_metrics

    # -- checkpointing ------------------------------------------------------

    def _checkpointer(self) -> "Checkpointer":
        if self._ckpt is None:
            raise ValueError("Trainer built without checkpoint_dir")
        return self._ckpt

    def save(self, state: TrainState, block: bool = True) -> None:
        """Checkpoint `state` at its step. block=False returns once every
        tensor is snapshotted and writes in the background (wait() or the
        next save or restore settles it). With a mesh every rank calls it:
        the full state is gathered (FSDP2), rank 0 writes it and the others
        wait at a barrier, until it is written (block) or snapshotted."""
        ckpt = self._checkpointer()
        from ..telemetry.flight import flight_record
        from ..telemetry.tracecontext import trace_scope

        t0 = self.clock.monotonic()
        # each checkpoint publish gets its own trace context
        with trace_scope():
            payload = state_payload(state)
            if distributed.is_coordinator():
                ckpt.write(state.step, payload, block=block)
            distributed.barrier()
            flight_record("checkpoint", op="save", step=state.step, block=block,
                          seconds=round(self.clock.monotonic() - t0, 6))
        self._last_saved_step = state.step
        self._last_save_mono = self.clock.monotonic()

    def restore(self, state: TrainState) -> Optional[TrainState]:
        """Restore the newest checkpoint into `state` (its model and
        optimizer, in place, on their device); None if there is none.
        With a mesh every rank calls it and reads the checkpoint; a
        checkpoint from any world size restores."""
        ckpt = self._checkpointer()
        t0 = self.clock.monotonic()
        restored = ckpt.restore_latest(state)
        if restored is not None:
            # the optimizer's state tensors were replaced: captured graphs
            # would write to the old ones
            self._graphs.clear()
            self.goodput.waste("restore", self.clock.monotonic() - t0)
            self._last_saved_step = restored.step
            self._last_save_mono = self.clock.monotonic()
        return restored

    def reload_checkpoints(self) -> Optional[int]:
        """The newest step in the checkpoint directory, re-scanned (another
        process may be writing it: the Evaluator watches the chief's)."""
        return self._checkpointer().latest_step()


class _CapturedStep:
    """One optimizer step of a trainer on a batch signature, as a CUDA
    graph.

    Everything the captured kernels touch keeps its address between
    replays, which is what the TMA tensor maps baked into K1-K5's launches
    need: the static batch (refilled with copy_ before the replays), the
    parameters and optimizer state (updated in place), the gradients
    (zeroed in place and re-attached to the parameters before each replay,
    in case an eager step set them to None), and the activations (from the
    graph's private memory pool).

    The optimizer is the one eager steps run: on CUDA, Trainer.init builds
    fused AdamW (its step counts on the device) or fused SGD, both
    reading the learning rate from a device scalar. The graph writes this step's rate into that scalar from a
    float64 step counter that it advances (WarmupCosine.on_device), where
    an eager step fills it from the host.

    `launches` holds the kernel launches one replay makes (ops/kernels
    LAUNCHES counts host calls, so a captured launch counts once, at
    capture) and `replays` the replays so far."""

    def __init__(self, trainer: Trainer, batch: Batch) -> None:
        lr = trainer.learning_rate
        if callable(lr) and not hasattr(lr, "on_device"):
            raise ValueError(
                "run_steps on CUDA needs a constant learning rate or a schedule "
                "with an on_device form (WarmupCosine)"
            )
        self.batch = {name: v.clone() for name, v in batch.items()}
        # the step count before the update
        self.count = torch.zeros((), dtype=torch.float64, device=trainer.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.grads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.outputs: Dict[str, torch.Tensor] = {}

    def _body(self, trainer: Trainer, state: TrainState) -> None:
        """The captured step: zero the grads in place, forward and
        backward, this step's rate from the device counter, the optimizer
        step, the counter's increment."""
        state.optimizer.zero_grad(set_to_none=False)
        loss, metrics = trainer._forward_backward(self.batch)
        lr = trainer.learning_rate
        if callable(lr):
            _set_lr(state.optimizer, lr.on_device(self.count))
        state.optimizer.step()
        self.count.add_(1)
        metrics["loss"] = loss
        self.outputs = metrics

    def warm_up_and_capture(
        self, trainer: Trainer, state: TrainState, batch: Batch,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One eager step (the first of the caller's n) on a side stream,
        which also builds the optimizer state and the gradients, then the
        capture of _body."""
        from ..ops import kernels

        current = torch.cuda.current_stream(trainer.device)
        side = torch.cuda.Stream(trainer.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            state, metrics = trainer.step(state, batch)
        current.wait_stream(side)
        self.grads = [(p, p.grad) for p in state.model.parameters() if p.grad is not None]
        state.model.train()
        before = dict(kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body(trainer, state)
        self.launches = {name: kernels.LAUNCHES[name] - before[name] for name in before}
        return state, metrics

    def prepare(self, state: TrainState, batch: Batch) -> None:
        """Before replays from state.step on `batch`."""
        for name, value in batch.items():
            self.batch[name].copy_(value)
        for param, grad in self.grads:
            param.grad = grad
        state.model.train()
        self.count.fill_(state.step)

    def replay(self, state: TrainState, batch: Batch, n: int) -> Dict[str, torch.Tensor]:
        """n replays from state.step on `batch`; -> the last one's metrics."""
        self.prepare(state, batch)
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        return {name: value.clone() for name, value in self.outputs.items()}


CHECKPOINT_FILE = "state.pt"


# what a param group holds for its device, not for the run: the rate's
# object (on CUDA a device scalar a captured graph reads) and the
# optimizer's form
_OWN_GROUP_KEYS = ("lr", "capturable", "fused")


def _load_optimizer(optimizer: torch.optim.Optimizer, load: Callable[[], object]) -> None:
    """load() (which loads a saved state into the optimizer), keeping each
    group's _OWN_GROUP_KEYS (the next step sets the rate from the
    schedule), so that a checkpoint written on one device restores onto
    another; step counts go where the kept form reads them (the device,
    for capturable or fused)."""
    own = [{k: g[k] for k in _OWN_GROUP_KEYS if k in g} for g in optimizer.param_groups]
    load()
    for group, kept in zip(optimizer.param_groups, own):
        group.update(kept)
        on_device = group.get("capturable") or group.get("fused")
        for param in group["params"]:
            st = optimizer.state.get(param, {})
            if on_device and isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(param.device, torch.float32)


def _param_names(state: TrainState) -> List[str]:
    """The model's parameter names in the optimizer's order (it was built
    from model.parameters()): what an index of optimizer.state_dict()
    stands for."""
    return [name for name, _ in state.model.named_parameters()]


def state_payload(state: TrainState) -> Optional[Dict[str, Any]]:
    """What a checkpoint holds: {"step", "model": the model's state_dict,
    "optimizer": the optimizer's state_dict, parameters keyed by index},
    full tensors at any world size and on any mesh. Under FSDP2, the tp
    plan or the ep layout they are gathered (_gathered_payload; a
    collective: every rank calls this) and rank 0 gets them, the other
    ranks None. Otherwise the tensors are the live ones."""
    plans = sharding_lib.layouts(state.model)
    if plans or sharding_lib.is_fully_sharded(state.model):
        return _gathered_payload(state, plans)
    return {"step": int(state.step), "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _map_moments(state: TrainState, optim: Dict[str, Any], fn) -> Dict[str, Any]:
    """An optimizer state_dict with fn(parameter name, tensor) applied to
    each state tensor shaped as its parameter (AdamW's moments, SGD's
    momentum), the 0-d step counts kept."""
    names = _param_names(state)
    out = {}
    for index, entry in optim["state"].items():
        out[index] = {key: fn(names[index], value)
                      if isinstance(value, torch.Tensor) and value.dim() > 0 else value
                      for key, value in entry.items()}
    return {**optim, "state": out}


def _gathered_payload(state: TrainState, plans) -> Optional[Dict[str, Any]]:
    """state_payload under FSDP2, the tp plan and the ep layout (`plans`):
    each parameter, buffer and optimizer moment gathered whole in turn,
    FSDP2's shards over the fsdp group first, then over the tp group and
    the ep group (sharding.gather_tensor; a collective: every rank calls
    this). Rank 0 moves each full tensor to its CPU as it arrives and the
    other ranks drop it, so the full state never piles up on a device;
    rank 0 gets the full payload."""
    coordinator = distributed.is_coordinator()

    def gather(name, value):
        full = sharding_lib.gather_tensor(name, value, plans)
        return full.cpu() if coordinator else None

    model = {name: gather(name, value) for name, value in state.model.state_dict().items()}
    optim = _map_moments(state, state.optimizer.state_dict(), gather)
    if not coordinator:
        return None
    return {"step": int(state.step), "model": model, "optimizer": optim}


def _apply_payload(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Load a checkpoint's payload into `state` in place. Under the tp
    plan and the ep layout each rank keeps its slices of the full tensors,
    and under FSDP2 its chunk of those, all cut locally (no collective)."""
    plans = sharding_lib.layouts(state.model)
    if plans or sharding_lib.is_fully_sharded(state.model):
        own = state.model.state_dict()
        params = dict(state.model.named_parameters())

        def local(name, value, like):
            # the full shape: like's (a DTensor's is its global one over
            # fsdp) times each plan's split, checked on every rank alike
            # before any cut (copy_ would broadcast a [1, n] into [m, n])
            want = list(like.shape)
            for lay in plans:
                rule = lay.rule(name)
                if rule is not None:
                    want[rule[0]] *= lay.size
            if list(value.shape) != want:
                raise ValueError(f"checkpoint tensor {name}: shape {tuple(value.shape)}, "
                                 f"the model's {tuple(want)}")
            return sharding_lib.fsdp_local(sharding_lib.local_slice(name, value, plans), like)

        saved = payload["model"]
        if set(saved) != set(own):
            raise KeyError(f"checkpoint names differ: missing {sorted(set(own) - set(saved))}, "
                           f"unexpected {sorted(set(saved) - set(own))}")
        with torch.no_grad():
            for name, live in own.items():
                value = sharding_lib.local_tensor(local(name, saved[name], live))
                sharding_lib.local_tensor(live).copy_(value)
        _load_optimizer(state.optimizer, lambda: state.optimizer.load_state_dict(_map_moments(
            state, payload["optimizer"], lambda name, value: local(name, value, params[name]))))
    else:
        state.model.load_state_dict(payload["model"])
        _load_optimizer(state.optimizer,
                        lambda: state.optimizer.load_state_dict(payload["optimizer"]))
    state.step = int(payload["step"])
    return state


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for value in obj.values():
            yield from _tensors(value)
    elif isinstance(obj, (list, tuple)):
        for value in obj:
            yield from _tensors(value)


def _clone_tree(obj, tensor_fn):
    if isinstance(obj, torch.Tensor):
        return tensor_fn(obj)
    if isinstance(obj, dict):
        return {k: _clone_tree(v, tensor_fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone_tree(v, tensor_fn) for v in obj)
    return obj


class Checkpointer:
    """The port's checkpoint format, in place of the reference's orbax
    manager (trainer.py:859-909): one directory per step, named by the
    step, holding `state.pt` (torch.save of state_payload's {"step",
    "model": the model's state_dict with its BatchNorm running statistics,
    "optimizer": the optimizer's state_dict}), the same at any world
    size. The newest `keep` steps are kept.

    A step is written under a temporary name in the same directory and
    then renamed into place (os.replace), so a reader (a restart, the
    Evaluator) never sees half a checkpoint: a name that is not a step
    number, or a step directory without state.pt, is ignored.

    save(block=False) snapshots every tensor before it returns (a device
    clone on a card, with an event the writer waits on; a copy on the
    CPU), since the trainer updates its state in place, and a writer
    thread copies the snapshot to the host and writes it. One save is in
    flight at a time; wait() settles it and raises its error, if any."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # bytes and seconds of the newest completed write
        self.last_write: Dict[str, float] = {}

    def steps(self) -> List[int]:
        """The complete steps in the directory, ascending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(
            int(name) for name in names
            if name.isdigit()
            and os.path.isfile(os.path.join(self.directory, name, CHECKPOINT_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), CHECKPOINT_FILE)

    def save(self, step: int, state: TrainState, block: bool = True) -> None:
        """Write `state` (a single process's) at `step`."""
        self.write(step, {**state_payload(state), "step": int(step)}, block=block)

    def write(self, step: int, payload: Dict[str, Any], block: bool = True) -> None:
        """Write a state_payload at `step`, snapshotting its tensors first."""
        self.wait()
        event = None
        if block:
            payload = _clone_tree(payload, lambda t: t.detach().to("cpu", copy=True))
            self._write(step, payload, None)
            return
        payload = _clone_tree(payload, lambda t: t.detach().clone())
        if any(t.is_cuda for t in _tensors(payload)):
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(
            target=self._write_in_background, args=(step, payload, event),
            name="checkpoint-writer", daemon=True,
        )
        self._thread.start()

    def _write_in_background(self, step, payload, event) -> None:
        try:
            self._write(step, payload, event)
        except BaseException as err:  # surfaced by wait()
            self._error = err

    def _write(self, step: int, payload, event: Optional[torch.cuda.Event]) -> None:
        start = time.monotonic()
        if event is not None:
            event.synchronize()
            payload = _clone_tree(payload, lambda t: t.cpu())
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}-{threading.get_ident()}")
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        self.last_write = {
            "step": step, "bytes": os.path.getsize(os.path.join(final, CHECKPOINT_FILE)),
            "seconds": time.monotonic() - start,
        }

    def wait(self) -> None:
        """Settle the save in flight; raise its error, if any."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def restore(self, step: int, state: TrainState) -> Optional[TrainState]:
        """Load `step` into `state` in place: the model's parameters and
        buffers, the optimizer's state (onto its parameters' device, by
        torch's rules) and the step. None if the step has vanished (a
        writer pruned it between listing and load)."""
        try:
            payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
        except FileNotFoundError:
            return None
        return _apply_payload(state, payload)

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        self.wait()
        step = self.latest_step()
        return None if step is None else self.restore(step, state)
