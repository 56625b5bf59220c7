"""GPT causal-LM pretraining entrypoint. Counterpart of
tf_operator_tpu/train/gpt.py.

    python -m tf_operator_tpu_torch.train.gpt --preset tiny --steps 20 --device cpu
    python -m tf_operator_tpu_torch.train.gpt --preset tiny --steps 6 --batch-size 4 \\
        --seq-len 128 --accum-steps 2 --checkpoint-dir /tmp/gpt-ckpt --device cpu
    python -m tf_operator_tpu_torch.train.gpt --preset small --batch-size 4 \\
        --seq-len 4096 --generate 56
    python -m tf_operator_tpu_torch.train.gpt --preset small --tp 2 --sp 2
    python -m tf_operator_tpu_torch.train.gpt --preset small --fsdp 2 --sp 2

Joins the TFJob's world from the operator-injected env
(parallel/distributed.py) and lays the model over a (dp, fsdp, sp, tp)
mesh by TRANSFORMER_RULES: DDP, FSDP2 on each block and the root with
--fsdp > 1, the Megatron plan with --tp > 1, or both (FSDP2 over each tp
rank's shards; parallel/sharding.py). With --fsdp and --sp, FSDP2
replicates over dp x sp.
--sp > 1 shards each row's sequence: causal ring attention
(--sp-strategy ring, the default) or Ulysses with the flash route
inside (--sp-strategy ulysses). --batch-size is the global batch, each
rank training on its rows (and its sequence shard). Runs on one CUDA device unless --device names
another. Attention is the
causal flash route (the Hopper kernels), with no flag, as in the
reference; the optimizer is AdamW with weight decay 0.01. The loop is
trainer.timed_run: restore from --checkpoint-dir when it holds a
checkpoint, one warm-up step outside the timed window, then fresh
synthetic Markov batches drawn and placed in the background
(InputPipeline) under a PreemptionGuard. --steps is the total budget,
restored steps included. A SIGTERM drains the step, writes a checkpoint
and exits 143 (retryable); a finished run writes a final checkpoint.
--accum-steps splits each batch into that many microbatches. Logs
tokens/sec (of the global batch), then a held-out eval; --generate N
then decodes N tokens greedily (models/gpt.py generate) from the first 8
tokens of each row of the warm-up batch, in a single process only (as
the reference, which skips it on several hosts); --weights-int8 and
--kv-int8 decode with int8 kernels (ops/quant.py, quantized once) and an
int8 KV cache. --monitoring-bind-addr serves the worker's telemetry
(train/observe.py TrainTelemetry) while it trains.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import add_mesh_flags, mesh_config
from .observe import add_monitoring_flag

logger = logging.getLogger("tf_operator_tpu_torch.train.gpt")

# seeds the weights, the batch stream and the held-out batch
SEED = 0
WEIGHT_DECAY = 0.01
PROMPT_LEN = 8


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=["tiny", "small"], default="small")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32, help="global batch")
    parser.add_argument(
        "--seq-len", type=int, default=2048,
        help="raises the preset's max_seq_len when longer",
    )
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument(
        "--warmup-steps", type=int, default=0,
        help="linear warmup to --learning-rate, then cosine decay to 10%% "
        "over --steps (0 = constant lr)",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="per-block rematerialization (torch.utils.checkpoint)",
    )
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
        "--generate", type=int, default=0, metavar="N",
        help="after training, greedily decode N tokens from a prompt",
    )
    parser.add_argument(
        "--weights-int8", action="store_true",
        help="int8 kernels for --generate (ops/quant.py: one quantization, per-feature-"
        "slice scales)",
    )
    parser.add_argument(
        "--kv-int8", action="store_true",
        help="int8 KV cache for --generate (per-(position, head) scales)",
    )
    parser.add_argument("--device", default=None, help="default: cuda")
    add_monitoring_flag(parser)
    add_mesh_flags(parser)
    args = parser.parse_args(argv)
    args.mesh = mesh_config(args)
    return args


def train(
    args: argparse.Namespace, attention_fn: Optional[Callable] = None,
    on_step: Optional[Callable] = None,
) -> Tuple[Dict[str, Any], Any]:
    """Train (and decode) as the flags say; returns the run's summary and
    the final TrainState (its model is the trained GPT). attention_fn
    replaces the causal flash route and the --sp attentions (the
    reference bench's attention="xla" twin passes plain causal attention;
    it has no flag);
    on_step(state) runs after every optimizer step. The summary is
    trainer.timed_run's, with --generate the decoded tokens (prompt
    included) and the wall ms per new token (all rows together, prefill
    included). A preempted run (summary["exit_code"] 143) decodes
    nothing. Runs in the world as it stands (main joins it)."""
    from .._device import resolve_device, seeded_model
    from ..models import gpt as gpt_lib
    from ..parallel import distributed
    from ..parallel.mesh import build_mesh, mesh_summary, sequence_attention
    from .observe import telemetry_server
    from .trainer import (
        Trainer, causal_lm_task, restore_if_any, timed_run, warmup_cosine_lr,
    )

    device = resolve_device(args.device)
    mesh = build_mesh(args.mesh, device)
    logger.info("mesh: %s", mesh_summary(mesh))
    if attention_fn is None:
        attention_fn = sequence_attention(mesh, args.sp_strategy, causal=True, flash=True)
        if attention_fn is not None:
            logger.info("causal %s attention over sp=%d", args.sp_strategy, args.sp)
    cfg = gpt_lib.GPT_PRESETS[args.preset]
    cfg = dataclasses.replace(
        cfg, max_seq_len=max(cfg.max_seq_len, args.seq_len), remat=args.remat
    )
    generator = torch.Generator().manual_seed(SEED)
    model = seeded_model(lambda g: gpt_lib.GPT(cfg, attention_fn=attention_fn, generator=g),
                         device, SEED)
    trainer = Trainer(
        model, causal_lm_task(),
        learning_rate=warmup_cosine_lr(args.learning_rate, args.steps, args.warmup_steps),
        weight_decay=WEIGHT_DECAY, device=device,
        checkpoint_dir=args.checkpoint_dir, accum_steps=args.accum_steps, mesh=mesh,
        shard_sequence=args.sp > 1,
    )
    with telemetry_server(trainer, args.monitoring_bind_addr):
        state = restore_if_any(trainer, trainer.init())
        state, summary, first_batch = timed_run(
            trainer, state,
            lambda gen: gpt_lib.synthetic_batch(gen, args.batch_size, args.seq_len, cfg),
            generator, args.steps, args.log_every, SEED, on_step=on_step,
        )
    if summary["exit_code"]:
        return summary, state
    if args.checkpoint_dir:
        trainer.save(state)
    if args.generate > 0 and distributed.world_size() > 1:
        logger.info("--generate skipped: it runs in a single process only")
    elif args.generate > 0:
        prompt = first_batch["input_ids"][:, :PROMPT_LEN]
        start = time.monotonic()  # the held-out eval has waited for the device
        out = gpt_lib.generate(model, prompt, max_new_tokens=args.generate,
                               kv_quant_int8=args.kv_int8, weights_int8=args.weights_int8)
        summary["generated"] = out.tolist()  # waits for the device
        summary["generate_ms_per_token"] = (time.monotonic() - start) * 1e3 / args.generate
        logger.info("generated: %s", summary["generated"][0])
    return summary, state


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """train(), returning only the summary."""
    return train(args)[0]


def main(argv: Optional[List[str]] = None, on_step: Optional[Callable] = None) -> int:
    """The CLI; returns its exit code: 0, or 143 after a SIGTERM."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from .._device import resolve_device
    from ..parallel import distributed

    with distributed.world(resolve_device(args.device)):
        return train(args, on_step=on_step)[0]["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
