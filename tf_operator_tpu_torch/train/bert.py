"""BERT MLM pretraining entrypoint. Counterpart of
tf_operator_tpu/train/bert.py.

    python -m tf_operator_tpu_torch.train.bert --preset tiny --steps 20 --device cpu
    python -m tf_operator_tpu_torch.train.bert --preset base --flash --packed \\
        --weight-decay 0.01

Runs on one CUDA device unless --device names another. --flash routes
attention through the Hopper kernels (ops/flash_attention.py); --packed
drops the all-ones attention mask (Trainer._prepare_batch). Fresh
synthetic batches come from a plain host loop; the first step is a
warmup outside the timed window. Logs tokens/sec, then a held-out eval.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("tf_operator_tpu_torch.train.bert")

# seeds the weights, the batch stream and the held-out batch
SEED = 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--preset", choices=["tiny", "base", "base-wide"], default="base",
        help="base-wide: same parameters as base with 6x128 heads",
    )
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument(
        "--weight-decay", type=float, default=1e-4,
        help="AdamW decoupled weight decay (optax.adamw's default 1e-4)",
    )
    parser.add_argument(
        "--warmup-steps", type=int, default=0,
        help="linear warmup to --learning-rate, then cosine decay to 10%% "
        "over --steps (0 = constant lr)",
    )
    parser.add_argument("--flash", action="store_true", help="flash attention kernels")
    parser.add_argument(
        "--packed", action="store_true",
        help="unpadded batches: drop the attention mask",
    )
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--log-every", type=int, default=20)
    return parser.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Train as the flags say; returns the run's summary: final train
    loss, tokens/sec over the timed steps, held-out eval loss and
    perplexity, and the number of forward and backward passes."""
    from .._device import resolve_device
    from ..models import bert as bert_lib
    from .trainer import Trainer, held_out_eval, mlm_task, warmup_cosine_lr

    device = resolve_device(args.device)
    cfg = {
        "base": bert_lib.BERT_BASE,
        "base-wide": bert_lib.BERT_BASE_WIDE,
        "tiny": bert_lib.BERT_TINY,
    }[args.preset]
    attention_fn = None
    if args.flash:
        from ..ops.flash_attention import flash_attention

        attention_fn = flash_attention
    generator = torch.Generator().manual_seed(SEED)
    model = bert_lib.BertForMLM(cfg, attention_fn=attention_fn, generator=generator)
    trainer = Trainer(
        model, mlm_task(model),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        weight_decay=args.weight_decay, packed=args.packed, device=device,
    )
    state = trainer.init()

    def make_batch(gen: torch.Generator):
        return bert_lib.synthetic_batch(gen, args.batch_size, args.seq_len, cfg)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warmup: first launches, allocator growth, kernel build
    state, metrics = trainer.step(state, trainer.place_batch(make_batch(generator)))
    float(metrics["loss"])
    sync()
    start = time.monotonic()
    for i in range(args.steps):
        state, metrics = trainer.step(state, trainer.place_batch(make_batch(generator)))
        if (i + 1) % args.log_every == 0:
            logger.info("step %d loss=%.4f", state.step, float(metrics["loss"]))
    loss = float(metrics["loss"])
    sync()
    elapsed = time.monotonic() - start
    tokens_per_sec = args.batch_size * args.seq_len * args.steps / elapsed if args.steps else 0.0
    logger.info(
        "tokens/sec on %s: %.1f (loss %.4f)",
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        tokens_per_sec, loss,
    )
    ev = held_out_eval(trainer, state, make_batch, SEED)
    logger.info("eval loss %.4f (ppl %.1f)", ev["loss"], ev["perplexity"])
    return {
        "loss": loss,
        "tokens_per_sec": tokens_per_sec,
        "seconds": elapsed,
        "eval_loss": ev["loss"],
        "eval_perplexity": ev["perplexity"],
        "forward_passes": args.steps + 2,  # warmup + steps + eval
        "backward_passes": args.steps + 1,
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
