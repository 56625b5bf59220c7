"""SIGTERM-graceful checkpointing: the port's copy of
tf_operator_tpu/train/preemption.py, the preemptible-worker contract.

A preempted node or a deleted pod gets SIGTERM and a grace period.
`PreemptionGuard` latches the signal instead of dying; `Trainer.fit` and
the CLIs' loops (through `maybe_preempt_exit`) drain the step in flight,
write a final checkpoint and exit with 143 = 128 + SIGTERM. That code is
in the operator's retryable set (the ExitCode restart policy retries
130, 137, 138 and 143), so the pod restarts and resumes from the saved
step, and a `--steps` budget counts the restored steps.

Several processes: the operator's SIGTERM may reach one rank before the
others (or only one, when one pod is deleted). A rank that stopped alone
would leave the others hanging at their next collective, so the loops
call `agree_on_preemption` once a step: every rank latches when any has,
and all save collectively and exit 143 on the same step.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("tf_operator_tpu_torch.preemption")

# 128 + SIGTERM: what the process would have exited with had it died
# un-gracefully — and a code the operator classifies as retryable, so
# the restart policy fires exactly as for a hard preemption
PREEMPTED_EXIT_CODE = 143


class PreemptionGuard:
    """Context manager that latches SIGTERM instead of dying.

    Inside the context, the first SIGTERM sets `triggered` (checked by
    the train loop between steps); the previous handler is restored on
    exit. Installing a handler is only possible on the main thread —
    elsewhere (threaded tests, notebook executors) the guard degrades
    to never-triggered rather than raising.
    """

    def __init__(self) -> None:
        self.triggered = threading.Event()
        self._prev = None
        self._installed = False

    def _handle(self, signum, frame) -> None:
        logger.warning("SIGTERM received — draining step, then checkpoint")
        self.triggered.set()

    def __enter__(self) -> "PreemptionGuard":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
            self._installed = True
        except ValueError:
            logger.debug("not on main thread; preemption guard inactive")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False


def agree_on_preemption(guard: PreemptionGuard) -> None:
    """Latch `guard` on every rank if any rank's is latched: one host
    all-reduce (MAX) under a world > 1, nothing in a single process."""
    from ..parallel import distributed

    if distributed.world_size() == 1:
        return
    latched = distributed.all_reduce_scalars(
        {"latched": float(guard.triggered.is_set())}, op="max")["latched"]
    if latched and not guard.triggered.is_set():
        logger.warning("another rank latched SIGTERM: draining this step too")
        guard.triggered.set()


def record_preemption(trainer, state, saved: bool) -> None:
    """Post-mortem trail for a SIGTERM: a `kind="preempt"` flight
    record (step, whether a checkpoint landed, seconds since the last
    durable save) plus a `train_preemptions_total` counter. Tolerant
    of bare trainers (the 143-contract tests drive this with fakes
    that have no registry or clock): every attribute is getattr'd."""
    from ..telemetry.flight import flight_record

    step = int(state.step)
    since_save = None
    last_mono = getattr(trainer, "_last_save_mono", None)
    clock = getattr(trainer, "clock", None)
    if last_mono is not None and clock is not None:
        since_save = round(clock.monotonic() - last_mono, 3)
    flight_record(
        "preempt",
        step=step,
        saved=bool(saved),
        seconds_since_last_save=since_save,
    )
    registry = getattr(trainer, "metrics_registry", None)
    if registry is None:
        from ..telemetry import default_registry

        registry = default_registry()
    registry.counter(
        "train_preemptions_total",
        "SIGTERM preemptions latched by the guard (graceful drain + "
        "checkpoint path)",
    ).inc()


def maybe_preempt_exit(guard, trainer, state, checkpoint_dir):
    """The CLI-side preemption epilogue, shared by every train CLI that
    runs its own step loop (bert/gpt/moe/resnet; Trainer.fit embeds the
    same logic): if the guard latched a SIGTERM, checkpoint (when
    configured), log either way, and return PREEMPTED_EXIT_CODE for
    the CLI to exit with; None means keep training."""
    if not guard.triggered.is_set():
        return None
    health = getattr(trainer, "health", None)
    saved = False
    if checkpoint_dir:
        if health is not None:
            health.set("checkpointing")
        trainer.save(state)
        saved = True
        logger.warning(
            "preempted at step %d — checkpoint saved, resume will "
            "continue from here", int(state.step),
        )
    else:
        logger.warning(
            "preempted at step %d with NO checkpoint_dir — progress "
            "will be lost on restart", int(state.step),
        )
    if health is not None:
        health.set("preempted")
    record_preemption(trainer, state, saved=saved)
    return PREEMPTED_EXIT_CODE
