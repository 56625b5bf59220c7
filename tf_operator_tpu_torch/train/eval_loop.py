"""Evaluator workload: watch a checkpoint directory and evaluate each new
step. Counterpart of tf_operator_tpu/train/eval_loop.py, the command of
the Evaluator replica (examples/v1/chief-evaluator.yaml).

    python -m tf_operator_tpu_torch.train.eval_loop --task mnist \\
        --checkpoint-dir /ckpt/mnist --out /ckpt/eval.jsonl --device cpu

Point it at the training job's --checkpoint-dir (a shared volume): it
polls the directory, restores every new step through the trainer's
Checkpointer, runs the task's held-out eval, appends one JSON line per
evaluation to --out, and exits 0 once a step at or after --until-step has
been evaluated (by default it runs forever, like the reference's
evaluator). --max-polls gives up (exit 1) after that many polls in a row
found nothing new to evaluate. Runs on CUDA unless --device names
another. It joins the world from the operator-injected env as the train
CLIs do; the operator injects that env into TPU replicas only, so an
Evaluator replica runs as one process, its model unwrapped.
--monitoring-bind-addr serves its telemetry (train/observe.py
TrainTelemetry, worker "evaluator") while it polls.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional

from .observe import add_monitoring_flag

logger = logging.getLogger("tf_operator_tpu_torch.train.eval_loop")

SEED = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", choices=["mnist", "gpt"], default="mnist")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument(
        "--preset", choices=["tiny", "small"], default="small",
        help="gpt task: MUST match the training CLI's --preset",
    )
    parser.add_argument(
        "--seq-len", type=int, default=2048,
        help="gpt task: MUST match the training CLI's --seq-len",
    )
    parser.add_argument("--poll-seconds", type=float, default=10.0)
    parser.add_argument("--out", default=None, help="append one JSON line per evaluation")
    parser.add_argument(
        "--until-step", type=int, default=None,
        help="exit 0 once a checkpoint at or after this step is evaluated "
        "(default: run forever)",
    )
    parser.add_argument(
        "--max-polls", type=int, default=None,
        help="give up (exit 1) after this many polls in a row with nothing new",
    )
    parser.add_argument("--device", default=None, help="default: cuda")
    add_monitoring_flag(parser, plane="evaluator")
    return parser.parse_args(argv)


def build(args: argparse.Namespace):
    """(trainer, make_batch) for the task: the model and optimizer the
    training CLI builds, so its checkpoints restore into them."""
    from ..parallel.mesh import build_mesh, mesh_summary
    from ..parallel.sharding import REPLICATED_RULES, TRANSFORMER_RULES
    from ..train.trainer import Trainer

    mesh = build_mesh(device=args.device)
    logger.info("mesh: %s", mesh_summary(mesh))
    if args.task == "mnist":
        from ..models import mnist as mnist_lib
        from ..train.trainer import classification_task

        model = mnist_lib.MnistCNN()
        trainer = Trainer(
            model, classification_task(), learning_rate=1e-3, weight_decay=0.0,
            device=args.device, checkpoint_dir=args.checkpoint_dir,
            mesh=mesh, rules=REPLICATED_RULES,
        )

        def make_batch(generator):
            return mnist_lib.synthetic_batch(generator, args.batch_size)
    else:
        import dataclasses

        from ..models import gpt as gpt_lib
        from ..train.trainer import causal_lm_task

        cfg = gpt_lib.GPT_TINY if args.preset == "tiny" else gpt_lib.GPT_SMALL
        cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, args.seq_len))
        model = gpt_lib.GPT(cfg)
        trainer = Trainer(
            model, causal_lm_task(), learning_rate=1e-4,
            device=args.device, checkpoint_dir=args.checkpoint_dir,
            mesh=mesh, rules=TRANSFORMER_RULES,
        )

        def make_batch(generator):
            return gpt_lib.synthetic_batch(generator, args.batch_size, args.seq_len, cfg)
    return trainer, make_batch


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from .._device import resolve_device
    from ..parallel import distributed

    args.device = resolve_device(args.device)
    with distributed.world(args.device):
        return evaluate_checkpoints(args)


def evaluate_checkpoints(args: argparse.Namespace) -> int:
    """The poll loop, with the telemetry server up when
    --monitoring-bind-addr names one; returns the exit code."""
    from .observe import telemetry_server

    trainer, make_batch = build(args)
    with telemetry_server(trainer, args.monitoring_bind_addr, worker="evaluator"):
        return poll(args, trainer, make_batch)


def poll(args: argparse.Namespace, trainer, make_batch) -> int:
    """Evaluate each new checkpoint until --until-step or --max-polls;
    returns the exit code."""
    from ..telemetry.flight import flight_record
    from ..telemetry.tracecontext import trace_scope
    from ..train.trainer import held_out_eval

    state = trainer.init()  # the restore target
    last_evaluated = -1
    empty_polls = 0
    while True:
        step = trainer.reload_checkpoints()
        restored = None
        if step is not None and step > last_evaluated:
            # None when the step vanished between listing and load (the
            # chief prunes to its newest few)
            restored = trainer.restore(state)
        if restored is None or restored.step <= last_evaluated:
            empty_polls += 1
            if args.max_polls is not None and empty_polls >= args.max_polls:
                logger.error("no new evaluable checkpoint after %d polls (last evaluated "
                             "step %d)", empty_polls, last_evaluated)
                return 1
            time.sleep(args.poll_seconds)
            continue
        empty_polls = 0
        state = restored
        # each evaluation gets its own trace context, as each checkpoint does
        with trace_scope():
            metrics = held_out_eval(trainer, state, make_batch, SEED)
            flight_record("evalpub", step=state.step,
                          loss=round(float(metrics.get("loss", float("nan"))), 6))
        logger.info("step %d eval: %s", state.step, metrics)
        if args.out:
            with open(args.out, "a") as handle:
                handle.write(json.dumps({"step": state.step, **{
                    k: round(float(v), 6) for k, v in metrics.items()
                }}) + "\n")
        last_evaluated = state.step
        if args.until_step is not None and state.step >= args.until_step:
            return 0


if __name__ == "__main__":
    sys.exit(main())
