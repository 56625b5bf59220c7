"""Mixture-of-experts causal-LM pretraining entrypoint. Counterpart of
tf_operator_tpu/train/moe.py.

    python -m tf_operator_tpu_torch.train.moe --preset tiny --steps 20 --device cpu
    python -m tf_operator_tpu_torch.train.moe --preset base --batch-size 8 --seq-len 1024

    python -m tf_operator_tpu_torch.train.moe --preset base --ep 2 --tp 2
    python -m tf_operator_tpu_torch.train.moe --preset base --fsdp 2 --ep 2

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and lays models/moe.py's MoELM over a (dp,
fsdp, ep, tp) mesh by MOE_RULES: DDP, or FSDP2 on each block and the
root with --fsdp > 1; --ep gives each rank e / ep experts, --tp splits
the attention, the dense MLPs, the embeddings, the head's vocabulary and
the experts' intermediate dimension (parallel/sharding.py), over plain
local shards (no DTensor), DDP over the dp ranks, or FSDP2 over each ep
and tp rank's shards with --fsdp > 1. Each router's load-balancing means
are the global batch's. --batch-size is the global batch. Runs on one CUDA device
unless --device names another. AdamW with weight decay 0.01 (the expert
kernels, bf16 in the base preset, keep bf16 moments). The loop is
trainer.timed_run, as train/gpt.py's: restore from --checkpoint-dir,
one warm-up step, then a fresh synthetic batch each step (InputPipeline)
under a PreemptionGuard (SIGTERM: checkpoint, exit 143); --steps is the
total budget, restored steps included; a finished run writes a final
checkpoint. Logs loss and router_aux (and router_z) per --log-every
steps, then tokens/sec, then a held-out eval with perplexity and
router_aux. --seq-len above the preset's max_position_embeddings raises
it (the position table would otherwise be indexed past its end).
--monitoring-bind-addr serves the worker's telemetry (train/observe.py
TrainTelemetry) while it trains. The weights are drawn on the device,
from a generator there seeded SEED (`_device.seeded_model`). A
checkpoint holds the full state at any mesh (gathered over ep and tp),
so it restores at any other.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("tf_operator_tpu_torch.train.moe")

# seeds the weights, the batch stream and the held-out batch
SEED = 0
WEIGHT_DECAY = 0.01


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from ..parallel.mesh import mesh_config
    from .observe import add_monitoring_flag

    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=["tiny", "base"], default="tiny")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32, help="global batch")
    parser.add_argument(
        "--seq-len", type=int, default=512,
        help="raises the preset's max_position_embeddings when longer",
    )
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--fsdp", type=int, default=1, help="FSDP2 shards over this many ranks")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert parallel: each rank holds num_experts / ep experts")
    parser.add_argument("--tp", type=int, default=1,
                        help="Megatron tensor parallel, the experts' intermediate dimension too")
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="resume from the newest checkpoint here; save on SIGTERM and at the end",
    )
    parser.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer step",
    )
    parser.add_argument(
        "--warmup-steps", type=int, default=0,
        help="linear warmup to --learning-rate, then cosine decay to 10%% "
        "over --steps (0 = constant lr)",
    )
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument("--device", default=None, help="default: cuda")
    add_monitoring_flag(parser)
    args = parser.parse_args(argv)
    args.mesh = mesh_config(args)
    return args


def config(args: argparse.Namespace):
    """The preset's MoEConfig, its position table at least --seq-len long."""
    from ..models import moe as moe_lib

    cfg = {"tiny": moe_lib.MOE_TINY, "base": moe_lib.MOE_BASE}[args.preset]
    if args.seq_len > cfg.max_position_embeddings:
        cfg = dataclasses.replace(cfg, max_position_embeddings=args.seq_len)
    return cfg


def train(args: argparse.Namespace) -> Tuple[Dict[str, Any], Any]:
    """Train as the flags say, in the world as it stands (main joins it);
    returns trainer.timed_run's summary (with router_aux, router_z and
    eval_router_aux) and the final TrainState."""
    from .._device import resolve_device, seeded_model
    from ..models import moe as moe_lib
    from ..parallel.mesh import build_mesh, mesh_summary
    from ..parallel.sharding import MOE_RULES
    from .observe import telemetry_server
    from .trainer import Trainer, moe_task, restore_if_any, timed_run, warmup_cosine_lr

    device = resolve_device(args.device)
    mesh = build_mesh(args.mesh, device)
    logger.info("mesh: %s", mesh_summary(mesh))
    cfg = config(args)
    generator = torch.Generator().manual_seed(SEED)
    model = seeded_model(lambda g: moe_lib.MoELM(cfg, generator=g), device, SEED)
    trainer = Trainer(
        model, moe_task(),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        weight_decay=WEIGHT_DECAY, device=device, checkpoint_dir=args.checkpoint_dir,
        accum_steps=args.accum_steps, mesh=mesh, rules=MOE_RULES,
    )
    with telemetry_server(trainer, args.monitoring_bind_addr):
        state = restore_if_any(trainer, trainer.init())
        state, summary, _ = timed_run(
            trainer, state,
            lambda gen: moe_lib.synthetic_batch(gen, args.batch_size, args.seq_len, cfg),
            generator, args.steps, args.log_every, SEED,
        )
    if args.checkpoint_dir and not summary["exit_code"]:
        trainer.save(state)
    return summary, state


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """train(), returning only the summary."""
    return train(args)[0]


def main(argv: Optional[List[str]] = None) -> int:
    """The CLI; returns its exit code: 0, or 143 after a SIGTERM."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from .._device import resolve_device
    from ..parallel import distributed

    with distributed.world(resolve_device(args.device)):
        return run(args)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
