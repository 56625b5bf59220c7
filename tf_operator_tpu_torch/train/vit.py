"""ViT training entrypoint. Counterpart of tf_operator_tpu/train/vit.py.

    python -m tf_operator_tpu_torch.train.vit --steps 100 --per-chip-batch 128
    python -m tf_operator_tpu_torch.train.vit --preset tiny --steps 3 --per-chip-batch 8 \\
        --device cpu

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and lays models/vit.py's ViT over a (dp,
fsdp, tp) mesh by TRANSFORMER_RULES (its blocks are BERT's): DDP, FSDP2
on each block and the root with --fsdp > 1, the Megatron plan on its
blocks with --tp > 1, or both (the patch embedding, position embedding and head
stay replicated, as the reference's rules leave them). The global batch is
--per-chip-batch x the world size. Runs on one CUDA device unless
--device names another. AdamW with weight decay 0.05 at
--learning-rate (optionally warmup then cosine decay), as the
reference. As in the reference, one synthetic batch is placed once and
reused by every step; the loop is trainer.timed_run with reuse_batch,
as train/resnet.py's: restore from --checkpoint-dir, one warm-up step,
the rest of the --steps budget under a PreemptionGuard (SIGTERM:
checkpoint, exit 143), a final checkpoint. --remat recomputes each
block in the backward; --accum-steps splits the batch into
microbatches; --profile-dir traces the first timed steps. Logs
images/sec. --monitoring-bind-addr serves the worker's telemetry
(train/observe.py TrainTelemetry) while it trains.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("tf_operator_tpu_torch.train.vit")

# seeds the weights and the batch
SEED = 0
WEIGHT_DECAY = 0.05


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from ..parallel.mesh import mesh_config
    from .observe import add_monitoring_flag

    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=["tiny", "b16"], default="b16")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--per-chip-batch", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--fsdp", type=int, default=1, help="FSDP2 shards over this many ranks")
    parser.add_argument("--tp", type=int, default=1,
                        help="Megatron tensor parallel over this many ranks")
    parser.add_argument("--remat", action="store_true",
                        help="per-block rematerialization (torch.utils.checkpoint)")
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
        help="linear warmup then cosine decay (0 = constant lr)",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of the first timed steps here",
    )
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument("--device", default=None, help="default: cuda")
    add_monitoring_flag(parser)
    args = parser.parse_args(argv)
    args.mesh = mesh_config(args)
    return args


def config(args: argparse.Namespace):
    from ..models import vit as vit_lib

    cfg = vit_lib.VIT_TINY if args.preset == "tiny" else vit_lib.VIT_B16
    return dataclasses.replace(cfg, remat=args.remat) if args.remat else cfg


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train as the flags say, in the world as it stands (main joins it);
    returns trainer.timed_run's summary (in images, with the final
    step's accuracy; "exit_code" 143 after a SIGTERM)."""
    from .._device import resolve_device, seeded_model
    from ..models import vit as vit_lib
    from ..parallel import distributed
    from ..parallel.mesh import build_mesh, mesh_summary
    from ..parallel.sharding import TRANSFORMER_RULES
    from .observe import telemetry_server
    from .trainer import (
        Trainer, classification_task, restore_if_any, timed_run, warmup_cosine_lr,
    )

    device = resolve_device(args.device)
    mesh = build_mesh(args.mesh, device)
    logger.info("mesh: %s", mesh_summary(mesh))
    cfg = config(args)
    global_batch = args.per_chip_batch * distributed.world_size()
    generator = torch.Generator().manual_seed(SEED)
    model = seeded_model(lambda g: vit_lib.ViT(cfg, generator=g), device, SEED)
    trainer = Trainer(
        model, classification_task(),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        weight_decay=WEIGHT_DECAY, device=device, checkpoint_dir=args.checkpoint_dir,
        accum_steps=args.accum_steps, mesh=mesh, rules=TRANSFORMER_RULES,
    )
    with telemetry_server(trainer, args.monitoring_bind_addr):
        state = restore_if_any(trainer, trainer.init())
        state, summary, _ = timed_run(
            trainer, state, lambda gen: vit_lib.synthetic_batch(gen, global_batch, cfg),
            generator, args.steps, args.log_every, SEED,
            profile_dir=args.profile_dir, reuse_batch=True,
        )
    if args.checkpoint_dir and not summary["exit_code"]:
        trainer.save(state)
    return summary


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
