"""The multichip dry run. Counterpart of __graft_entry__.dryrun_multichip.

    python -m tf_operator_tpu_torch.testing.dryrun --world 2 [--device cpu]

`dryrun_multichip(n)` launches a world of n processes over gloo (each
joins from the env the operator injects, parallel/distributed.py), on
cuda unless the caller names another device (on one card every rank
shares cuda:0, gloo staging its collectives through host memory), and
each runs one full training step per mesh factorization, at the
reference's factorizations and sizes, rank 0 printing the reference's
`dryrun ... ok` lines:

- dp: a small ResNet (CONV_RULES, SGD with momentum) at
  _dp_mesh_config, dp >= 2;
- bert: BERT MLM at _mesh_config (sp > 1: ring attention, then a
  forward and backward through Ulysses on the same mesh);
- gpt: GPT_TINY over dp x tp, then generate(mesh=);
- moe-pipeline: PipelinedMoELM (models/moe_pipeline.py) at
  _moe_mesh_config, one Adam step on the LM loss plus the router aux.

At world 2 the phases run at tp 2, dp 2 and ep 2 with one stage. At
world 4 the dp phase runs at dp 2 x tp 2, BERT at fsdp 2 x tp 2 (FSDP2
over the tp plan's local shards, parallel/sharding.py), GPT at dp 2 x tp
2 and the pipeline at pp 2 x ep 2. A mesh that fails raises on every
rank: there is no fallback to another factorization.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional

import torch

SEED = 0
LAUNCH_TIMEOUT_S = 600


def _mesh_config(n_devices: int):
    """The reference's multi-axis factorization: tp innermost, fsdp next,
    dp absorbing the rest."""
    from ..parallel.mesh import MeshConfig

    if n_devices % 8 == 0:
        return MeshConfig(dp=-1, fsdp=2, tp=2, sp=2)
    if n_devices % 4 == 0:
        return MeshConfig(dp=-1, fsdp=2, tp=2)
    if n_devices % 2 == 0:
        return MeshConfig(dp=-1, tp=2)
    return MeshConfig(dp=-1)


def _dp_mesh_config(n_devices: int):
    """The reference's factorization with dp > 1 explicitly."""
    from ..parallel.mesh import MeshConfig

    if n_devices % 8 == 0:
        return MeshConfig(dp=-1, fsdp=2, tp=2)
    if n_devices % 4 == 0:
        return MeshConfig(dp=-1, tp=2)
    return MeshConfig(dp=-1)


def _moe_mesh_config(n_devices: int):
    """The reference's pipeline and expert factorization, tp innermost."""
    from ..parallel.mesh import MeshConfig

    if n_devices % 8 == 0:
        return MeshConfig(dp=-1, pp=2, ep=2, tp=2)
    if n_devices % 4 == 0:
        return MeshConfig(dp=-1, pp=2, ep=2)
    if n_devices % 2 == 0:
        return MeshConfig(dp=-1, ep=2)
    return MeshConfig(dp=-1)


def _say(text: str) -> None:
    from ..parallel import distributed

    if distributed.is_coordinator():
        print(text, flush=True)


def _shape(mesh) -> dict:
    return {axis: mesh.size(axis) for axis in ("dp", "pp", "fsdp", "ep", "sp", "tp")}


def _dryrun_dp(n_devices: int, device: str) -> None:
    from ..models import resnet as resnet_lib
    from ..parallel.mesh import build_mesh
    from ..parallel.sharding import CONV_RULES
    from ..train.trainer import Trainer, classification_task

    config = _dp_mesh_config(n_devices)
    mesh = build_mesh(config, device)
    dp, _, fsdp, _, _, _ = config.resolve(n_devices)
    assert n_devices < 2 or dp >= 2, f"dp axis must be >1, got {dp}"
    gen = torch.Generator().manual_seed(SEED)
    model = resnet_lib.ResNet(stage_sizes=(1, 1), num_classes=10, width=8, generator=gen)
    trainer = Trainer(model, classification_task(), learning_rate=0.1, optimizer="sgd",
                      device=device, mesh=mesh, rules=CONV_RULES)
    batch = resnet_lib.synthetic_batch(gen, 2 * dp * max(1, fsdp), 32, num_classes=10)
    state = trainer.init()
    _, metrics = trainer.step(state, trainer.place_batch(batch))
    loss = float(metrics["loss"])
    assert loss == loss, "dp ResNet loss is NaN"
    _say(f"dryrun dp ok: mesh={_shape(mesh)} dp={dp} loss={loss:.4f}")


def _dryrun_bert(n_devices: int, device: str, config=None) -> None:
    from ..models import bert as bert_lib
    from ..parallel.mesh import build_mesh, sequence_attention
    from ..train.trainer import Trainer, mlm_task

    config = config or _mesh_config(n_devices)
    mesh = build_mesh(config, device)
    cfg = bert_lib.BertConfig(vocab_size=2048, hidden_size=256, num_layers=2, num_heads=8,
                              intermediate_size=1024, max_position_embeddings=256)
    sequence_parallel = config.sp > 1
    attention_fn = sequence_attention(mesh, "ring") if sequence_parallel else None
    gen = torch.Generator().manual_seed(SEED)
    model = bert_lib.BertForMLM(cfg, attention_fn=attention_fn, generator=gen)
    trainer = Trainer(model, mlm_task(), learning_rate=1e-3, device=device, mesh=mesh,
                      shard_sequence=sequence_parallel)
    dp, _, fsdp, _, sp, _ = config.resolve(n_devices)
    batch, seq = 2 * dp * fsdp, 64 * max(1, sp)
    placed = trainer.place_batch(bert_lib.synthetic_batch(gen, batch, seq, cfg))
    state = trainer.init()
    _, metrics = trainer.step(state, placed)
    loss = float(metrics["loss"])
    assert loss == loss, "BERT loss is NaN"
    uly = ""
    if sequence_parallel:
        # the second sp strategy: the same weights, forward and backward
        # through the all-to-all re-sharding on the same mesh
        for i in range(cfg.num_layers):
            block = getattr(state.model.encoder, f"layer_{i}")
            block.attention.attention_fn = sequence_attention(mesh, "ulysses")
        uly_loss, _ = trainer.task.loss_fn(trainer.module, placed)
        uly_loss.backward()
        assert float(uly_loss) == float(uly_loss), "ulysses loss is NaN"
        uly = f" ulysses_loss={float(uly_loss):.4f}"
    _say(f"dryrun bert ok: mesh={_shape(mesh)} batch={batch} seq={seq} loss={loss:.4f}{uly}")


def _dryrun_gpt(n_devices: int, device: str) -> None:
    from ..models import gpt as gpt_lib
    from ..parallel.mesh import MeshConfig, build_mesh
    from ..train.trainer import Trainer, causal_lm_task

    config = MeshConfig(dp=-1, tp=2) if n_devices % 2 == 0 else MeshConfig(dp=-1)
    mesh = build_mesh(config, device)
    dp, _, _, _, _, tp = config.resolve(n_devices)
    cfg = gpt_lib.GPT_TINY
    gen = torch.Generator().manual_seed(SEED)
    model = gpt_lib.GPT(cfg, generator=gen)
    trainer = Trainer(model, causal_lm_task(), learning_rate=1e-3, weight_decay=0.0,
                      device=device, mesh=mesh)
    sample = gpt_lib.synthetic_batch(gen, 2 * dp, 64, cfg)
    state = trainer.init()
    state, metrics = trainer.step(state, trainer.place_batch(sample))
    loss = float(metrics["loss"])
    assert loss == loss, "GPT loss is NaN"
    out = gpt_lib.generate(state.model, sample["input_ids"][:, :8], 4, mesh=mesh)
    assert tuple(out.shape) == (sample["input_ids"].shape[0], 12)
    _say(f"dryrun gpt ok: mesh={_shape(mesh)} dp={dp} tp={tp} loss={loss:.4f} "
         f"decode={tuple(out.shape)}")


def _dryrun_moe_pipeline(n_devices: int, device: str) -> None:
    from ..models import moe as moe_lib
    from ..models.moe_pipeline import PipelinedMoELM
    from ..parallel import distributed
    from ..parallel.mesh import build_mesh, local_rows

    config = _moe_mesh_config(n_devices)
    mesh = build_mesh(config, device)
    dp, pp, fsdp, ep, _, _ = config.resolve(n_devices)
    cfg = moe_lib.MoEConfig(
        vocab_size=1024, hidden_size=128, num_layers=2 * max(1, pp), num_heads=4,
        intermediate_size=256, max_position_embeddings=128, num_experts=2 * max(1, ep),
        experts_per_token=2, moe_every=1)
    model = PipelinedMoELM(cfg, mesh, n_microbatches=2, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    batch = 4 * dp * fsdp  # 2 microbatches x 2 examples per data shard
    ids = torch.randint(0, cfg.vocab_size, (batch, 64),
                        generator=torch.Generator().manual_seed(SEED))
    local = ids[local_rows(mesh, batch)].to(device)
    logits, aux = model(local)
    loss = moe_lib.lm_loss(logits, local) + aux
    loss.backward()
    model.sync_gradients()
    optimizer.step()
    total = distributed.all_reduce_scalars({"loss": float(loss)})["loss"] / (dp * fsdp)
    assert total == total, "MoE loss is NaN"
    _say(f"dryrun moe-pipeline ok: mesh={_shape(mesh)} batch={batch} "
         f"experts={cfg.num_experts} layers={cfg.num_layers} loss={total:.4f}")


def run_phases(n_devices: int, device: str) -> None:
    """Every phase, in this process's world of n_devices ranks."""
    from ..parallel.mesh import MeshConfig

    _dryrun_dp(n_devices, device)
    _dryrun_bert(n_devices, device)
    if n_devices % 8 == 0:
        _dryrun_bert(n_devices, device, config=MeshConfig(dp=-1, sp=4))
    _dryrun_gpt(n_devices, device)
    _dryrun_moe_pipeline(n_devices, device)
    _say("dryrun_multichip ok")


def rank_env(rank: int, world: int, port: int, threads: int = 1) -> dict:
    """The env the operator injects into replica `rank` of a `world`-pod
    job whose coordinator listens on 127.0.0.1:port."""
    from ..api.types import (
        ENV_COORDINATOR_OVERRIDE,
        ENV_NUM_PROCESSES,
        ENV_PROCESS_ID,
        ENV_TPU_WORKER_HOSTNAMES,
        ENV_TPU_WORKER_ID,
    )

    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    env.update({
        ENV_TPU_WORKER_ID: str(rank), ENV_PROCESS_ID: str(rank),
        ENV_NUM_PROCESSES: str(world),
        ENV_TPU_WORKER_HOSTNAMES: ",".join(f"worker-{i}" for i in range(world)),
        ENV_COORDINATOR_OVERRIDE: f"127.0.0.1:{port}",
    })
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """One training step per mesh factorization in a world of n_devices
    processes launched here (or, inside such a world already, in it) on
    `device` (default cuda); rank 0's lines printed. Raises RuntimeError
    with the ranks' logs where a rank failed."""
    from .._device import resolve_device
    from ..parallel import distributed

    device = str(resolve_device(device))
    if distributed.is_initialized():
        run_phases(n_devices, device)
        return
    package = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    procs = []
    for rank in range(n_devices):
        env = rank_env(rank, n_devices, port)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [package, env.get("PYTHONPATH")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.testing.dryrun", "--rank-of",
             str(n_devices), "--device", device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        results.append((proc.returncode, out, err))
    print(results[0][1], end="", flush=True)
    codes = [code for code, _, _ in results]
    if codes == [0] * n_devices:
        return
    raise RuntimeError(f"dryrun ranks exited {codes}: " + "\n".join(
        f"rank {r}: {err[-2000:]}" for r, (_, _, err) in enumerate(results)))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, default=None,
                        help="launch a world of this many processes")
    parser.add_argument("--rank-of", type=int, default=None,
                        help="run as one rank of a world of this size (env as the operator's)")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    if args.rank_of is None:
        dryrun_multichip(args.world or 2, args.device)
        return 0
    from .._device import resolve_device
    from ..parallel import distributed

    device = str(resolve_device(args.device))
    torch.set_num_threads(1)
    distributed.initialize(device, backend="gloo")
    try:
        run_phases(args.rank_of, device)
        distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
