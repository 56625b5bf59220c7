"""How a model is laid over the mesh. Counterpart of
tf_operator_tpu/parallel/sharding.py's training rule sets.

The reference's rules map parameter paths to PartitionSpecs and let
GSPMD insert the collectives. The port's rule sets keep their names and
become wrap plans, applied by `parallelize`:

- REPLICATED_RULES: every parameter replicated: DDP over the world,
  whatever the mesh's shape (the fsdp axis then only splits the batch,
  as in the reference).
- CONV_RULES: DDP where fsdp == 1, the only way the ResNet CLI runs it;
  with fsdp > 1, FSDP2 (`fully_shard`) on the root alone.
- TRANSFORMER_RULES: DDP where fsdp == 1; with fsdp > 1, FSDP2 on each
  TransformerBlock and then on the root, over the (dp, fsdp) mesh, so
  dp > 1 and fsdp > 1 together give HSDP (replicated over dp, sharded
  over fsdp). The tensor-parallel half of the reference's rules (tp)
  waits for ROADMAP item 4; the serve rule sets for theirs.
- MOE_RULES: the MoE LM's (models/moe.py) as TRANSFORMER_RULES lays it,
  FSDP2 on each dense and MoE block and the root with fsdp > 1. The
  reference's rules also shard the experts over its ep axis, which
  build_mesh refuses until expert parallelism lands (ROADMAP queue 1,
  item 7).

DDP broadcasts rank 0's parameters when it wraps; FSDP2 does not, so the
models draw their weights from a seeded CPU generator, the same on every
rank. Whatever the plan, `parallelize` gives each TpuBatchNorm and each
MoE router the mesh's batch group (mesh.batch_group) when it spans more
than one rank, so their statistics are the global batch's (sync BN, and
the router's load-balancing means). DDP does not broadcast
buffers at each forward: the running statistics come from all-reduced
batch statistics, the same on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class WrapPlan:
    """name: the reference rule set's. shard: parameters are sharded over
    the mesh's fsdp axis when it is > 1. blocks: the class names of the
    submodules that each get their own FSDP2 unit before the root."""

    name: str
    shard: bool = False
    blocks: Tuple[str, ...] = ()


REPLICATED_RULES = WrapPlan("REPLICATED_RULES")
CONV_RULES = WrapPlan("CONV_RULES", shard=True)
TRANSFORMER_RULES = WrapPlan("TRANSFORMER_RULES", shard=True, blocks=("TransformerBlock",))
MOE_RULES = WrapPlan("MOE_RULES", shard=True, blocks=("TransformerBlock", "MoEBlock"))


def shards_parameters(mesh, rules: WrapPlan) -> bool:
    return rules.shard and mesh["fsdp"].size() > 1


def parallelize(model: nn.Module, mesh, rules: WrapPlan, device: torch.device) -> nn.Module:
    """Wrap `model` (already on `device`) for the mesh; returns the module
    to call: the model itself under FSDP2 (`shard`, where the rules shard
    and the mesh's fsdp axis is > 1, or where the model was sharded
    already), else its DDP wrapper, whose `.module` is the model. Its
    TpuBatchNorms and MoE routers sync over the mesh's batch group
    (sync_batch_norm)."""
    sync_batch_norm(model, mesh)
    if is_fully_sharded(model):
        return model
    if shards_parameters(mesh, rules):
        return shard(model, mesh, rules)
    from torch.nn.parallel import DistributedDataParallel

    device_ids = None
    if device.type == "cuda":
        device_ids = [device.index if device.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(model, device_ids=device_ids, broadcast_buffers=False)


def sync_batch_norm(model: nn.Module, mesh) -> None:
    """Set the sync_group of each TpuBatchNorm and each MoE router (the
    modules whose statistics are over the batch) to the mesh's batch
    group where that group holds more than one rank (over one rank the
    all-reduce would be a copy)."""
    import torch.distributed as dist

    from ..models.moe import TopKRouter
    from ..models.norm import TpuBatchNorm
    from .mesh import batch_group

    group = batch_group(mesh)
    if dist.get_world_size(group) == 1:
        return
    for module in model.modules():
        if isinstance(module, (TpuBatchNorm, TopKRouter)):
            module.sync_group = group


def shard(model: nn.Module, mesh, rules: WrapPlan) -> nn.Module:
    """FSDP2 in place: `fully_shard` on each of the rules' blocks, then on
    the root, over the mesh (its fsdp axis shards, its dp axis
    replicates). The parameters become DTensor shards, so an optimizer is
    built after this. Called by parallelize; a caller may also shard a
    model over a mesh whose fsdp axis is 1 (one rank), where sharding
    and replication compute the same step."""
    from torch.distributed.fsdp import fully_shard

    if rules.blocks:
        for module in list(model.modules()):
            if type(module).__name__ in rules.blocks:
                fully_shard(module, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def is_fully_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


@contextlib.contextmanager
def no_grad_sync(module: nn.Module) -> Iterator[None]:
    """Backward passes inside keep their gradients local (DDP's no_sync,
    FSDP2's set_requires_gradient_sync(False)): the microbatches of an
    accumulated step but the last."""
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(module, DistributedDataParallel):
        with module.no_sync():
            yield
    elif is_fully_sharded(module):
        module.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            module.set_requires_gradient_sync(True)
    else:
        yield


def local_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), else the tensor."""
    from torch.distributed.tensor import DTensor

    return tensor.to_local() if isinstance(tensor, DTensor) else tensor
