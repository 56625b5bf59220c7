"""dist-MNIST training entrypoint, the workload inside the hello-world
TFJob's pods. Counterpart of tf_operator_tpu/train/mnist.py.

    python -m tf_operator_tpu_torch.train.mnist --steps 200 --batch-size 64 --device cpu
    python -m tf_operator_tpu_torch.train.mnist --steps 1000 --batch-size 512 \\
        --target-accuracy 0.99 --checkpoint-dir /ckpt/mnist --acc-json MNIST_ACC.json

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and trains data parallel over it (DDP,
REPLICATED_RULES); --batch-size is the global batch, each rank training
on its rows. Runs on one CUDA device unless --device names another.
Trains MnistCNN
with Adam (AdamW with weight decay 0, the same update as optax.adam)
through Trainer.fit on fresh synthetic batches: --steps is the total
budget (restored steps count), --checkpoint-dir resumes from and saves
every 100 steps (async) and at the end, a SIGTERM writes a checkpoint
and exits 143, --summary-dir writes scalar summaries, --profile-dir
traces a few steady-state steps. Then a held-out eval on 4096 fresh
samples, over every rank's rows (every rank logs the same accuracy);
--target-accuracy fails the run (exit 1) below it, and --acc-json (rank
0) writes the accuracy artifact. --monitoring-bind-addr serves the
worker's telemetry (train/observe.py TrainTelemetry) while it trains.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional

import torch

from .observe import add_monitoring_flag

logger = logging.getLogger("tf_operator_tpu_torch.train.mnist")

# seeds the weights; the batch stream and the held-out batch have their own
SEED = 0
BATCH_SEED = 1
EVAL_SEED = 999_999
EVAL_SAMPLES = 4096
CHECKPOINT_EVERY = 100


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch-size", type=int, default=64, help="global batch")
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--target-accuracy", type=float, default=None)
    parser.add_argument(
        "--acc-json", default=None,
        help="write the accuracy artifact (steps, wall seconds, final train "
        "metrics, held-out eval accuracy) to this path",
    )
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument(
        "--summary-dir", default=None,
        help="write scalar summaries here (metrics.jsonl always; TensorBoard "
        "events when torch.utils.tensorboard is available)",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of a few steady-state steps here",
    )
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--device", default=None, help="default: cuda")
    add_monitoring_flag(parser)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    from .._device import resolve_device
    from ..parallel import distributed

    device = resolve_device(args.device)
    with distributed.world(device) as proc:
        return train(args, device, proc)


def train(args: argparse.Namespace, device: torch.device, proc) -> int:
    from ..models import mnist as mnist_lib
    from ..parallel.mesh import build_mesh, mesh_summary
    from ..parallel.sharding import REPLICATED_RULES
    from .observe import telemetry_server
    from .trainer import Trainer, classification_task

    mesh = build_mesh(device=device)
    logger.info("mesh: %s", mesh_summary(mesh))
    model = mnist_lib.MnistCNN(generator=torch.Generator().manual_seed(SEED))
    trainer = Trainer(
        model, classification_task(), learning_rate=args.learning_rate,
        weight_decay=0.0, device=device, checkpoint_dir=args.checkpoint_dir,
        mesh=mesh, rules=REPLICATED_RULES,
    )
    with telemetry_server(trainer, args.monitoring_bind_addr):
        return fit_and_evaluate(args, device, proc, trainer)


def fit_and_evaluate(args: argparse.Namespace, device: torch.device, proc, trainer) -> int:
    """train()'s run on its trainer: fit, save, the held-out eval and the
    accuracy gate; returns the exit code."""
    from ..models import mnist as mnist_lib
    from .preemption import PREEMPTED_EXIT_CODE
    from .summaries import maybe_writer
    from .trainer import restore_if_any

    state = restore_if_any(trainer, trainer.init())

    def batches():
        generator = torch.Generator().manual_seed(BATCH_SEED)
        while True:
            yield mnist_lib.synthetic_batch(generator, args.batch_size)

    train_start = time.monotonic()
    with maybe_writer(args.summary_dir, proc.process_id) as writer:
        state, metrics = trainer.fit(
            state, batches(), steps=args.steps, log_every=args.log_every,
            checkpoint_every=CHECKPOINT_EVERY if args.checkpoint_dir else None,
            metrics_callback=writer.scalars, profile_dir=args.profile_dir,
        )
    wall_seconds = time.monotonic() - train_start
    logger.info("final: %s", metrics)
    if metrics.get("preempted"):
        # fit() wrote the checkpoint; the retryable code makes the
        # operator's ExitCode policy restart the pod, which resumes
        logger.warning("exiting with retryable code %d after preemption", PREEMPTED_EXIT_CODE)
        return PREEMPTED_EXIT_CODE
    if args.checkpoint_dir:
        trainer.save(state)

    # held-out eval: fresh samples of the same distribution, never trained on
    eval_batch = trainer.place_batch(
        mnist_lib.synthetic_batch(torch.Generator().manual_seed(EVAL_SEED), EVAL_SAMPLES)
    )
    eval_accuracy = float(trainer.evaluate(state, eval_batch)["accuracy"])
    logger.info("held-out eval accuracy: %.4f (n=%d)", eval_accuracy, EVAL_SAMPLES)

    if args.acc_json and proc.is_coordinator:
        with open(args.acc_json, "w") as handle:
            json.dump({
                "metric": "dist_mnist_eval_accuracy",
                "eval_accuracy": round(eval_accuracy, 4),
                "eval_samples": EVAL_SAMPLES,
                "final_train_metrics": {k: round(float(v), 4) for k, v in metrics.items()},
                "steps": args.steps,
                "global_batch": args.batch_size,
                "wall_seconds": round(wall_seconds, 2),
                "target": args.target_accuracy,
                "platform": "gpu" if device.type == "cuda" else device.type,
                "chip": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "note": "synthetic learnable MNIST stand-in (models/mnist.py "
                "synthetic_batch); eval batch drawn fresh, never trained on",
            }, handle, indent=1)

    # the gate judges held-out accuracy whether or not the artifact was asked for
    if args.target_accuracy is not None and eval_accuracy < args.target_accuracy:
        logger.error("eval accuracy %.4f below target %.4f", eval_accuracy, args.target_accuracy)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
