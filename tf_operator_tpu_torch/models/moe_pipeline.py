"""Pipelined MoE LM: the pp x ep x dp composition of the MoE decoder.
Counterpart of tf_operator_tpu/models/moe_pipeline.py.

The embedding and the LM head run on every rank (replicated); the
homogeneous stack of MoE blocks streams through the GPipe schedule over
the mesh's pp axis (parallel/pipeline.py), each stage holding its L / S
blocks with their experts laid out over ep (MoEMlp's expert-parallel
mode, its partial outputs summed over the ep group: the reference's
_block_spec, :85-91). The tp axis, where the mesh has one, replicates, as
the reference's pipeline specs leave it.

    model = PipelinedMoELM(cfg, mesh, n_microbatches=2, generator=gen)
    logits, aux = model(input_ids)        # this rank's rows
    (lm_loss(logits, input_ids) + aux).backward()
    model.sync_gradients()                # the mean over dp x fsdp
    optimizer.step()

Each rank draws the whole model from `generator` (the same on every
rank) in MoELM's order and keeps its part, so the pipeline holds the
weights a one-process MoELM drawn from the same seed holds. The router
inside the pipeline averages over its own microbatch (no sync_group):
the aux is the reference's mean of means (parallel/pipeline.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..parallel.mesh import axis_size
from ..parallel.pipeline import pipeline_apply
from ..parallel.sharding import MOE_RULES, WrapPlan, apply_expert_parallel, shard_state_dict
from .moe import MoEConfig, MoELM, causal_mask, total_aux_loss

# the pipeline's layout: the experts on ep; no tp plan (tp replicates)
PIPELINE_RULES = WrapPlan("PIPELINE", ep=MOE_RULES.ep)


def stage_layers(num_layers: int, mesh) -> range:
    """The global indices of this rank's stage's layers."""
    n_stages = axis_size(mesh, "pp")
    per = num_layers // n_stages
    stage = 0 if mesh is None else mesh.index("pp")
    return range(stage * per, (stage + 1) * per)


def local_state_dict(state: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a full MoELM-named state dict (homogeneous
    blocks): the embeddings, the head, its stage's layers, with its ep
    rank's experts."""
    num_layers = len({name.split(".")[0] for name in state if name.startswith("layer_")})
    mine = {f"layer_{i}" for i in stage_layers(num_layers, mesh)}
    kept = {name: tensor for name, tensor in state.items()
            if not name.startswith("layer_") or name.split(".")[0] in mine}
    return shard_state_dict(kept, mesh, PIPELINE_RULES)


class PipelinedMoELM(MoELM):
    """MoELM's embedding and head around this rank's stage of MoE blocks
    (layer_{i} for i in stage_layers, the global names), run under the
    GPipe schedule. forward(input_ids) -> (logits, aux): this rank's rows'
    logits and the router losses summed over the layers, averaged over
    the microbatches and the data shards."""

    def __init__(
        self, config: MoEConfig, mesh, n_microbatches: int = 2,
        device=None, generator=None,
    ) -> None:
        if config.moe_every != 1:
            raise ValueError("pipelined stack must be homogeneous: moe_every=1")
        n_stages = axis_size(mesh, "pp")
        if config.num_layers % n_stages != 0:
            raise ValueError(
                f"{config.num_layers} layers not divisible by {n_stages} pipeline stages")
        ep = axis_size(mesh, "ep")
        if config.num_experts % ep != 0:
            raise ValueError(f"{config.num_experts} experts not divisible by ep={ep}")
        super().__init__(config, generator=generator)
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.n_stages = n_stages
        self.layer_ids = stage_layers(config.num_layers, mesh)
        for i in range(config.num_layers):
            if i not in self.layer_ids:
                delattr(self, f"layer_{i}")
        if ep > 1:
            apply_expert_parallel(self, mesh, PIPELINE_RULES)
        if device is not None:
            self.to(device)

    def blocks(self) -> List:
        return [getattr(self, f"layer_{i}") for i in self.layer_ids]

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        seq = input_ids.shape[-1]
        positions = torch.arange(seq, device=input_ids.device)
        x = self.embed(input_ids, positions[None])
        mask = causal_mask(seq, input_ids.device)

        def layer_fn(block, h):
            h, losses = block(h, mask)
            return h, total_aux_loss({name: [value] for name, value in losses.items()})

        x, aux = pipeline_apply(layer_fn, self.blocks(), x, mesh=self.mesh,
                                n_microbatches=self.n_microbatches, layer_aux=True)
        return self.head(x), aux

    apply_with_aux = forward

    def sync_gradients(self) -> None:
        """Every gradient averaged over the mesh's batch group (dp x fsdp),
        one all-reduce per dtype; nothing where that group is one rank."""
        group = None if self.mesh is None else self.mesh.batch_group
        if group is None:
            return
        import torch.distributed as dist

        n = dist.get_world_size(group)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for param in self.parameters():
            if param.grad is not None:
                by_dtype.setdefault(param.grad.dtype, []).append(param.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
