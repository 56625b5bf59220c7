"""The training engine's core. Counterpart of
tf_operator_tpu/train/trainer.py: the state object, `Task`,
`classification_task`, `mlm_task`, `warmup_cosine_lr`, `held_out_eval`
and `Trainer` (init, step, evaluate, place_batch).

JAX's train state is immutable and each step returns a new one; here
the state holds the model and its optimizer, and `Trainer.step` updates
both in place (no second copy of parameters or moments) and returns the
same object.

AdamW has optax's semantics: b1 0.9, b2 0.999, eps 1e-8 added outside
the square root, and decoupled weight decay on every parameter in one
group, p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), which is
what torch.optim.AdamW computes. optax.adamw defaults to weight decay
1e-4 and torch to 1e-2: the port defaults to optax's and callers pass
it explicitly.

The reference's Trainer takes any optax transformation; the port takes
`optimizer="adamw"` (the default, as above) or `"sgd"`, optax.sgd(lr,
momentum=0.9) as train/resnet.py builds it: trace = g + 0.9 * trace
from a zero trace, p <- p - lr * trace. That is torch.optim.SGD with
momentum 0.9, dampening 0, no Nesterov and no weight decay, whose first
step's buf = g agrees with the zero start. Both read the learning rate
(or schedule) per step.

BatchNorm running statistics are module buffers: `step` runs the model
in train mode, which updates them in the forward, and `evaluate` in
eval mode, which reads them, as the reference threads `batch_stats`
through its loss function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

Batch = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class Task:
    """How to compute loss for a model family: loss_fn(batch, train)
    -> (loss, aux metrics), running the model the task was made for."""

    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


def warmup_cosine_lr(peak: float, steps: int, warmup_steps: int) -> LearningRate:
    """Constant `peak` when warmup_steps == 0; otherwise linear warmup
    from 0 to `peak`, then cosine decay to 10% of it, as
    optax.warmup_cosine_decay_schedule with decay_steps clamped to
    warmup_steps + 1."""
    if not warmup_steps:
        return peak
    decay_steps = max(steps, warmup_steps + 1)
    end = peak * 0.1

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return end + (peak - end) * cosine

    return schedule


def classification_task(model: nn.Module) -> Task:
    """Softmax cross-entropy of f32 logits against integer labels, mean
    over the batch, plus accuracy; the model reads `training` itself."""

    def loss_fn(batch: Batch, train: bool = True):
        logits = model(batch["image"]).float()
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": accuracy}

    return Task(loss_fn=loss_fn)


def mlm_task(model: nn.Module) -> Task:
    from ..models.bert import mlm_loss

    def loss_fn(batch: Batch, train: bool = True):
        logits = model(batch["input_ids"], batch.get("attention_mask"))
        return mlm_loss(logits, batch["labels"], batch["mlm_weights"]), {}

    return Task(loss_fn=loss_fn)


HELD_OUT_FOLD = 2**31 - 1
OPTIMIZERS = ("adamw", "sgd")
SGD_MOMENTUM = 0.9


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
    ) -> None:
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} not in {OPTIMIZERS}")
        self.optimizer = optimizer
        self.model = model
        self.task = task
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.packed = packed
        self.device = resolve_device(device)

    def _prepare_batch(self, batch: Batch) -> Batch:
        """Packed (unpadded) training: the all-ones mask is pure
        overhead even for the in-kernel mask path, so it is dropped
        here, at the mechanism."""
        if self.packed and "attention_mask" in batch:
            batch = {k: v for k, v in batch.items() if k != "attention_mask"}
        return batch

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self) -> TrainState:
        """Move the model to the trainer's device and build its optimizer."""
        self.model.to(self.device)
        if self.optimizer == "sgd":
            optimizer = torch.optim.SGD(
                self.model.parameters(), lr=self._lr(0), momentum=SGD_MOMENTUM,
                dampening=0.0, nesterov=False, weight_decay=0.0,
            )
        else:
            optimizer = torch.optim.AdamW(
                self.model.parameters(), lr=self._lr(0), betas=(0.9, 0.999),
                eps=1e-8, weight_decay=self.weight_decay,
            )
        return TrainState(step=0, model=self.model, optimizer=optimizer)

    def place_batch(self, batch: Batch) -> Batch:
        batch = self._prepare_batch(batch)
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on `batch` (as place_batch returns it).
        Updates the state in place and returns it with the step's
        metrics as device tensors; reading them waits for the device."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.task.loss_fn(batch, train=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = self._lr(state.step)
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    @torch.no_grad()
    def evaluate(self, state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        """One no-gradient pass; returns the task's metrics and loss."""
        state.model.eval()
        loss, aux = self.task.loss_fn(self._prepare_batch(batch), train=False)
        metrics = dict(aux)
        metrics["loss"] = loss
        return metrics
