"""BERT MLM pretraining entrypoint. Counterpart of
tf_operator_tpu/train/bert.py.

    python -m tf_operator_tpu_torch.train.bert --preset tiny --steps 20 --device cpu
    python -m tf_operator_tpu_torch.train.bert --preset base --flash --packed \\
        --weight-decay 0.01
    python -m tf_operator_tpu_torch.train.bert --preset base --tp 2 --sp 2 \\
        --sp-strategy ulysses --flash --packed
    python -m tf_operator_tpu_torch.train.bert --preset base --fsdp 2 --tp 2 \\
        --flash --packed

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and lays the model over a (dp, fsdp, sp, tp)
mesh by TRANSFORMER_RULES: DDP, FSDP2 with --fsdp > 1, the Megatron
plan with --tp > 1, or both (FSDP2 over each tp rank's shards). --sp > 1 shards each row's sequence: ring attention
(--sp-strategy ring, the default; --flash then has no effect, as the
reference warns) or Ulysses, with the flash route inside under --flash.
--batch-size is the global batch, each rank training on its rows (and
its sequence shard). Runs on one CUDA device unless --device names
another. --flash routes attention through the Hopper kernels
(ops/flash_attention.py); --packed drops the all-ones attention mask
(Trainer._prepare_batch; so does --sp, whose attentions refuse one). The loop is
trainer.timed_run, as in train/gpt.py: restore from --checkpoint-dir,
one warm-up step outside the timed window, fresh synthetic batches
through InputPipeline under a PreemptionGuard (SIGTERM: checkpoint, exit
143), --steps as the total budget, a final checkpoint. --accum-steps
splits each batch into microbatches, re-weighted by their mlm weight
mass; --profile-dir traces the first timed steps (torch.profiler).
Logs tokens/sec (of the global batch), then a held-out eval.
--monitoring-bind-addr serves the worker's telemetry (train/observe.py
TrainTelemetry) while it trains.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, List, Optional

import torch

from ..parallel.mesh import add_mesh_flags, mesh_config
from .observe import add_monitoring_flag

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
    parser.add_argument("--batch-size", type=int, default=32, help="global batch")
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
    add_mesh_flags(parser)
    args = parser.parse_args(argv)
    args.mesh = mesh_config(args)
    return args


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Train as the flags say, in the world as it stands (main joins it);
    returns the run's summary (trainer.timed_run's; "exit_code" 143 after
    a SIGTERM)."""
    from .._device import resolve_device, seeded_model
    from ..models import bert as bert_lib
    from ..parallel.mesh import build_mesh, mesh_summary, sequence_attention
    from .observe import telemetry_server
    from .trainer import Trainer, mlm_task, restore_if_any, timed_run, warmup_cosine_lr

    device = resolve_device(args.device)
    mesh = build_mesh(args.mesh, device)
    logger.info("mesh: %s", mesh_summary(mesh))
    cfg = {
        "base": bert_lib.BERT_BASE,
        "base-wide": bert_lib.BERT_BASE_WIDE,
        "tiny": bert_lib.BERT_TINY,
    }[args.preset]
    attention_fn = sequence_attention(mesh, args.sp_strategy, flash=args.flash)
    if attention_fn is not None:
        if args.flash and args.sp_strategy == "ring":
            logger.warning(
                "--flash has no effect with --sp-strategy ring (the ring computes its own "
                "blockwise fold); use --sp-strategy ulysses to pair sp with the kernel")
        logger.info("%s attention over sp=%d", args.sp_strategy, args.sp)
    elif args.flash:
        from ..ops.flash_attention import flash_attention

        attention_fn = flash_attention
    generator = torch.Generator().manual_seed(SEED)
    model = seeded_model(
        lambda g: bert_lib.BertForMLM(cfg, attention_fn=attention_fn, generator=g),
        device, SEED)
    trainer = Trainer(
        model, mlm_task(),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        weight_decay=args.weight_decay, packed=args.packed, device=device,
        checkpoint_dir=args.checkpoint_dir, accum_steps=args.accum_steps, mesh=mesh,
        shard_sequence=args.sp > 1,
    )

    def make_batch(gen: torch.Generator):
        return bert_lib.synthetic_batch(gen, args.batch_size, args.seq_len, cfg)

    with telemetry_server(trainer, args.monitoring_bind_addr):
        state = restore_if_any(trainer, trainer.init())
        state, summary, _ = timed_run(
            trainer, state, make_batch, generator, args.steps, args.log_every, SEED,
            profile_dir=args.profile_dir,
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
