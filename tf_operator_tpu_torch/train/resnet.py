"""ResNet-50 training entrypoint. Counterpart of
tf_operator_tpu/train/resnet.py.

    python -m tf_operator_tpu_torch.train.resnet --steps 100 --per-chip-batch 128
    python -m tf_operator_tpu_torch.train.resnet --small --steps 2 --device cpu \\
        --conv3-impl pallas

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and trains data parallel over it (DDP,
CONV_RULES over a dp mesh), TpuBatchNorm's statistics all-reduced over
the mesh's batch group (sync BN); the global batch is --per-chip-batch x the world
size, each rank training on its rows. Runs on one CUDA device unless
--device names another. SGD with
momentum 0.9 at --learning-rate (optionally warmup then cosine decay),
as the reference. --conv3-impl pallas routes the stride-1 3x3
bottleneck convs through the Hopper kernels K4/K5 (ops/conv_bn.py).
--small is the reference's CPU smoke model (stage sizes (1, 1), 10
classes, f32, images of at most 64 pixels); under --conv3-impl pallas
it is width 64 instead of 8 so that the 3x3 convs take the kernel
route (C % 64 == 0), as the reference's bench smoke does
(benchmarks/model_benches.py:97-100).

The loop is trainer.timed_run, as in train/gpt.py, with one change: as
in the reference, one synthetic batch is placed once and reused by
every step (reuse_batch), since a fresh 224x224 batch of 256 f32 images
is 154 MB of host work per step and would set the pace. So: restore
from --checkpoint-dir when it holds a checkpoint, one warm-up step
outside the timed window, then the rest of the --steps budget (restored
steps count) under a PreemptionGuard (SIGTERM: checkpoint, exit 143)
and a final checkpoint. --accum-steps splits the batch into
microbatches (BatchNorm statistics update once per microbatch);
--profile-dir traces the first timed steps; --monitoring-bind-addr
serves the worker's telemetry (train/observe.py TrainTelemetry) while it
trains. Logs images/sec.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, List, Optional

import torch

from .observe import add_monitoring_flag

logger = logging.getLogger("tf_operator_tpu_torch.train.resnet")

# seeds the weights and the batch
SEED = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--per-chip-batch", type=int, default=128)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--learning-rate", type=float, default=0.1)
    parser.add_argument(
        "--warmup-steps", type=int, default=0,
        help="linear warmup then cosine decay (0 = constant lr)",
    )
    parser.add_argument("--small", action="store_true", help="tiny variant (CPU smoke)")
    parser.add_argument(
        "--conv3-impl", choices=["xla", "pallas"], default="xla",
        help="pallas: stride-1 3x3 convs on the Hopper kernels K4/K5",
    )
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="resume from the newest checkpoint here; save on SIGTERM and at the end",
    )
    parser.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer step",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of the first timed steps here",
    )
    add_monitoring_flag(parser)
    return parser.parse_args(argv)


def build_model(args: argparse.Namespace, generator: torch.Generator):
    """The model the flags name, and its number of classes."""
    from ..models import resnet as resnet_lib

    if args.small:
        width = 64 if args.conv3_impl == "pallas" else 8
        model = resnet_lib.ResNet(
            stage_sizes=(1, 1), num_classes=10, width=width, dtype=torch.float32,
            conv3_impl=args.conv3_impl, generator=generator,
        )
        return model, 10
    return resnet_lib.ResNet50(conv3_impl=args.conv3_impl, generator=generator), 1000


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Train as the flags say, in the world as it stands (main joins it);
    returns the run's summary (trainer.timed_run's, in images; "exit_code"
    143 after a SIGTERM)."""
    from .._device import resolve_device
    from ..models import resnet as resnet_lib
    from ..parallel import distributed
    from ..parallel.mesh import MeshConfig, build_mesh, mesh_summary
    from ..parallel.sharding import CONV_RULES
    from .observe import telemetry_server
    from .trainer import Trainer, classification_task, restore_if_any, timed_run, warmup_cosine_lr

    device = resolve_device(args.device)
    mesh = build_mesh(MeshConfig(dp=-1), device)
    logger.info("mesh: %s", mesh_summary(mesh))
    global_batch = args.per_chip_batch * distributed.world_size()
    if args.small:
        args.image_size = min(args.image_size, 64)
    generator = torch.Generator().manual_seed(SEED)
    model, classes = build_model(args, generator)
    trainer = Trainer(
        model, classification_task(),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        device=device, optimizer="sgd",
        checkpoint_dir=args.checkpoint_dir, accum_steps=args.accum_steps,
        mesh=mesh, rules=CONV_RULES,
    )

    def make_batch(gen: torch.Generator):
        return resnet_lib.synthetic_batch(gen, global_batch, args.image_size, classes)

    with telemetry_server(trainer, args.monitoring_bind_addr):
        state = restore_if_any(trainer, trainer.init())
        state, summary, _ = timed_run(
            trainer, state, make_batch, generator, args.steps, args.log_every, SEED,
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
