"""ResNet-50 training entrypoint. Counterpart of
tf_operator_tpu/train/resnet.py.

    python -m tf_operator_tpu_torch.train.resnet --steps 100 --per-chip-batch 128
    python -m tf_operator_tpu_torch.train.resnet --small --steps 2 --device cpu \\
        --conv3-impl pallas

Runs on one CUDA device unless --device names another. SGD with
momentum 0.9 at --learning-rate (optionally warmup then cosine decay),
as the reference. --conv3-impl pallas routes the stride-1 3x3
bottleneck convs through the Hopper kernels K4/K5 (ops/conv_bn.py).
--small is the reference's CPU smoke model (stage sizes (1, 1), 10
classes, f32, images of at most 64 pixels); under --conv3-impl pallas
it is width 64 instead of 8 so that the 3x3 convs take the kernel
route (C % 64 == 0), as the reference's bench smoke does
(benchmarks/model_benches.py:97-100).

As in the reference, one synthetic batch is placed once and reused by
every step: a fresh 224x224 batch of 256 f32 images is 154 MB of host
work per step and would set the pace. The first step is a warmup
outside the timed window. Logs images/sec.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Optional

import torch

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
    """Train as the flags say; returns the run's summary: final train
    loss, images/sec over the timed steps, their seconds, and the number
    of forward and backward passes."""
    from .._device import resolve_device
    from ..models import resnet as resnet_lib
    from .trainer import Trainer, classification_task, warmup_cosine_lr

    device = resolve_device(args.device)
    if args.small:
        args.image_size = min(args.image_size, 64)
    generator = torch.Generator().manual_seed(SEED)
    model, classes = build_model(args, generator)
    trainer = Trainer(
        model, classification_task(model),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        device=device, optimizer="sgd",
    )
    state = trainer.init()
    batch = trainer.place_batch(resnet_lib.synthetic_batch(
        generator, args.per_chip_batch, args.image_size, classes
    ))

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warmup: first launches, allocator growth, kernel build
    state, metrics = trainer.step(state, batch)
    float(metrics["loss"])
    sync()
    start = time.monotonic()
    for i in range(args.steps):
        state, metrics = trainer.step(state, batch)
        if (i + 1) % args.log_every == 0:
            logger.info("step %d loss=%.4f", state.step, float(metrics["loss"]))
    loss = float(metrics["loss"])
    sync()
    elapsed = time.monotonic() - start
    images_per_sec = args.per_chip_batch * args.steps / elapsed if args.steps else 0.0
    logger.info(
        "images/sec on %s: %.1f (loss %.4f)",
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        images_per_sec, loss,
    )
    return {
        "loss": loss,
        "images_per_sec": images_per_sec,
        "seconds": elapsed,
        "forward_passes": args.steps + 1,  # warmup + steps
        "backward_passes": args.steps + 1,
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
