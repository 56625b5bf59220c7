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
  TransformerBlock and then on the root, over the mesh's (dp x sp, fsdp)
  DeviceMesh, so dp or sp > 1 together with fsdp > 1 give HSDP
  (replicated over dp x sp, sharded over fsdp). With tp > 1, the
  tensor-parallel half of the reference's rules (sharding.py:25-37) as
  an explicit Megatron plan over plain local tensors
  (`apply_tensor_parallel`): query/key/value are
  column-parallel on heads, mlp_in column-parallel, attn_out and
  mlp_out row-parallel (their partial products all-reduced over tp
  before the bias, which is added once), the token and position
  embeddings and the LM/MLM head vocab-parallel (rows on tp: a masked
  lookup then an all-reduce; the head's logits stay split on the vocab
  and ops/losses.py's vocab-parallel cross-entropy reads them). The
  column-parallel biases are split with their outputs; every other
  parameter is replicated. The plan uses no DTensor: each tp rank holds
  plain local tensors, and with fsdp > 1 FSDP2 then shards those over
  its (dp x sp, fsdp) DeviceMesh, one per tp coordinate (2-D: fsdp x
  tp). No DTensor spans tp, and no checkpoint calls DTensor's gathers
  (on the card's torch they crash over gloo with CUDA tensors):
  `gather_tensor` gathers FSDP2's dim-0 shards over the fsdp group
  itself. With sp > 1 each model's `seq_index` is set to the rank's
  sequence shard (its positions' offset) and the attention is the
  caller's ring or Ulysses attention_fn. The replicated parameters and
  each tp rank's shards reduce their gradients over the mesh's grad
  group (dp x fsdp x sp): DDP on that group where it holds more than
  one rank and fsdp == 1, else FSDP2's reduce-scatter over fsdp and
  all-reduce over dp x sp.
- MOE_RULES: the MoE LM's (models/moe.py), FSDP2 on each dense and MoE
  block, each MoEMlp's experts and its router, and the root with fsdp >
  1. Its tp plan is TRANSFORMER_RULES'
  plus the expert kernels' intermediate dimension (expert_in
  column-parallel, expert_out row-parallel: the reference's
  sharding.py:43-47); its ep layout (`apply_expert_parallel`) gives each
  ep rank its e / ep experts. The router is replicated: it routes over
  every expert, and each MoEMlp combines its rank's experts and sums the
  partial outputs over the mesh's expert group (ep x tp). A batch's rows
  split over dp x fsdp only, so every ep and tp rank sees the same rows
  and computes the replicated parameters' full gradients (models/moe.py
  says how the expert path keeps them whole); every parameter then
  reduces over the grad group, as under tp. With fsdp > 1 FSDP2 shards
  each ep and tp coordinate's local tensors over fsdp (fsdp x ep, fsdp
  x ep x tp).

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
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import distributed


# The Megatron plan of TRANSFORMER_RULES over the port's parameter names:
# (pattern, the dimension split over tp, role). "column": the output of a
# layer fed the replicated activation; "row": the input of a layer whose
# partial products are all-reduced; "embed": a table's rows (vocab or
# positions); "head": the output vocabulary of the LM or MLM head.
_TP_TRANSFORMER = (
    (r"(?:.*\.)?attention\.(?:query|key|value)\.kernel", 1, "column"),
    (r"(?:.*\.)?attention\.(?:query|key|value)\.bias", 0, "column"),
    (r"(?:.*\.)?attention\.attn_out\.kernel", 0, "row"),
    (r"(?:.*\.)?mlp_in\.(?:weight|bias)", 0, "column"),
    (r"(?:.*\.)?mlp_out\.weight", 1, "row"),
    (r"(?:.*\.)?(?:lm_head|mlm_head)\.(?:weight|bias)", 0, "head"),
    (r"(?:.*\.)?(?:token_embed|position_embed)\.weight", 0, "embed"),
)
# The same plan over the int8 twin's buffers (ops/quant.py
# QuantDenseGeneral: DenseGeneral's [in..., out...] kernel layout, for
# nn.Linear too, and a kernel_scale over the output features). The twin
# is quantized from the whole model before it is laid out, so a
# row-parallel kernel's scales (attn_out, mlp_out: the split axis is the
# contracted one) are the whole kernel's, replicated; a column-parallel
# layer's scales split with its outputs.
_TP_TRANSFORMER_INT8 = (
    (r"(?:.*\.)?attention\.(?:query|key|value)\.kernel", 1, "column"),
    (r"(?:.*\.)?attention\.(?:query|key|value)\.(?:kernel_scale|bias)", 0, "column"),
    (r"(?:.*\.)?attention\.attn_out\.kernel", 0, "row"),
    (r"(?:.*\.)?mlp_in\.kernel", 1, "column"),
    (r"(?:.*\.)?mlp_in\.(?:kernel_scale|bias)", 0, "column"),
    (r"(?:.*\.)?mlp_out\.kernel", 0, "row"),
    (r"(?:.*\.)?lm_head\.kernel", 1, "head"),
    (r"(?:.*\.)?lm_head\.(?:kernel_scale|bias)", 0, "head"),
    (r"(?:.*\.)?(?:token_embed|position_embed)\.weight", 0, "embed"),
)
# MOE_RULES' tp plan: the expert kernels' intermediate dimension ([e, h, f]
# and [e, f, h]: MoEMlp sums the partial outputs over its expert group),
# then TRANSFORMER_RULES'; the router matches none and is replicated
_TP_MOE = (
    (r"(?:.*\.)?moe_mlp\.expert_in", 2, "expert"),
    (r"(?:.*\.)?moe_mlp\.expert_out", 1, "expert"),
) + _TP_TRANSFORMER
# MOE_RULES' ep layout: the expert dimension of both expert kernels
_EP_MOE = ((r"(?:.*\.)?moe_mlp\.expert_(?:in|out)", 0, "expert"),)


@dataclasses.dataclass(frozen=True)
class WrapPlan:
    """name: the reference rule set's. shard: parameters are sharded over
    the mesh's fsdp axis when it is > 1. blocks: the class names of the
    submodules that each get their own FSDP2 unit before the root (a
    unit's own parameters must share one dtype). tp:
    the tensor-parallel plan, (pattern, dim, role) over parameter names;
    ep: the expert layout, the same form over the ep axis. Either is
    empty where the rule set has none: a mesh whose axis is > 1 then
    replicates every parameter over it (its ranks compute the same step),
    as the reference's rules without a spec on that axis do."""

    name: str
    shard: bool = False
    blocks: Tuple[str, ...] = ()
    tp: Tuple[Tuple[str, int, str], ...] = ()
    ep: Tuple[Tuple[str, int, str], ...] = ()
    # the tp plan over the model's int8 twin (ops/quant.py), where the
    # rule set has one
    tp_int8: Tuple[Tuple[str, int, str], ...] = ()


REPLICATED_RULES = WrapPlan("REPLICATED_RULES")
CONV_RULES = WrapPlan("CONV_RULES", shard=True)
TRANSFORMER_RULES = WrapPlan("TRANSFORMER_RULES", shard=True, blocks=("TransformerBlock",),
                             tp=_TP_TRANSFORMER, tp_int8=_TP_TRANSFORMER_INT8)
# FSDP2 shards a unit's parameters as one flat group of one dtype, and
# MoE-base's expert kernels are bf16 beside f32 weights: each MoEMlp (its
# experts) and its TopKRouter (f32) are units of their own
MOE_RULES = WrapPlan("MOE_RULES", shard=True,
                     blocks=("TransformerBlock", "MoEBlock", "MoEMlp", "TopKRouter"),
                     tp=_TP_MOE, ep=_EP_MOE)


# The sharded decode step's layout over a serving mesh's 'model' axis (the
# reference's SERVE_DECODE_RULES and SERVE_CACHE_RULES, sharding.py:60-89,
# over the port's names; `tp` is the plan over that axis). Only output
# dimensions split: the query/key/value kernels and biases on their heads,
# mlp_in on its outputs. attn_out, mlp_out, the embeddings, the layer
# norms and the LM head stay whole on every shard, and the decode programs
# (models/gpt.py ShardedPagedSlotDecodeStep) join the shards' attention
# outputs and MLP activations before those full-width contractions: a
# partial contraction summed afterwards would reorder the floating-point
# reduction, and the sharded engine owes the single-device step's chains.
SERVE_DECODE_RULES = WrapPlan("SERVE_DECODE_RULES", tp=(
    (r"(?:.*\.)?attention\.(?:query|key|value)\.kernel", 1, "column"),
    (r"(?:.*\.)?attention\.(?:query|key|value)\.bias", 0, "column"),
    (r"(?:.*\.)?mlp_in\.(?:weight|bias)", 0, "column"),
))
# The paged KV pool, [num_blocks, block_size, heads, head_dim] per layer
# and per k/v (and the int8 scale pools, [num_blocks, block_size, heads]):
# the heads dimension splits on 'model', with the qkv heads, so a write
# and a read never cross shards; a shard's pool is total / model shards.
SERVE_CACHE_RULES = WrapPlan("SERVE_CACHE_RULES", tp=((r".*", 2, "heads"),))


def model_shard(state: Dict[str, torch.Tensor], rules: WrapPlan, index: int,
                size: int) -> Dict[str, torch.Tensor]:
    """Shard `index` of `size` of a state dict over one axis by the rules'
    tp plan: each planned tensor its slice (a view), every other tensor
    itself (SERVE_DECODE_RULES over a serving mesh's 'model' axis)."""
    out = {}
    for name, tensor in state.items():
        rule = tp_rule(name, rules.tp)
        out[name] = tensor if rule is None else _shard(tensor, rule[0], index, size)
    return out


def shards_parameters(mesh, rules: WrapPlan) -> bool:
    return rules.shard and mesh.shape["fsdp"] > 1


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """Logits split on their vocab over a tp group: this rank's columns
    start at `start` (ops/losses.py vocab_parallel_cross_entropy)."""

    start: int
    group: object


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A model laid out by a plan over one mesh axis: this rank's index
    of `size` in `group`, and the plan; set on the model as
    `tensor_parallel` (the tp plan) or `expert_parallel` (the ep
    layout)."""

    group: object
    rank: int
    size: int
    plan: Tuple[Tuple[str, int, str], ...]

    def rule(self, name: str) -> Optional[Tuple[int, str]]:
        return tp_rule(name, self.plan)


def tp_rule(name: str, plan) -> Optional[Tuple[int, str]]:
    """(dim, role) of the plan's first pattern matching parameter `name`,
    or None for a replicated parameter."""
    for pattern, dim, role in plan:
        if re.fullmatch(pattern, name):
            return dim, role
    return None


def _shard(tensor: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if tensor.shape[dim] % size:
        raise ValueError(
            f"dimension {dim} of shape {tuple(tensor.shape)} does not split {size} ways")
    return tensor.chunk(size, dim=dim)[rank]


def shard_state_dict(
    state: Dict[str, torch.Tensor], mesh, rules: WrapPlan,
) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state dict by the rules' tp plan and ep
    layout (the whole dict where the mesh's tp and ep axes are 1)."""
    out = dict(state)
    if mesh is None:
        return out
    for axis, plan in (("ep", rules.ep), ("tp", rules.tp)):
        size = mesh.size(axis)
        if size == 1:
            continue
        for name, tensor in out.items():
            rule = tp_rule(name, plan)
            if rule is not None:
                out[name] = _shard(tensor, rule[0], mesh.index(axis), size).clone()
    return out


def layouts(model: nn.Module) -> List[TensorParallel]:
    """The plans a model was laid out by: its tp plan, then its ep
    layout, where each was applied."""
    return [lay for lay in (getattr(model, "tensor_parallel", None),
                            getattr(model, "expert_parallel", None)) if lay is not None]


def _fsdp_shard(tensor) -> Tuple[int, object, int, int]:
    """Where FSDP2 splits a DTensor parameter (or moment): (its dimension,
    the mesh dimension's process group, this rank's index there, its
    size)."""
    for mesh_dim, placement in enumerate(tensor.placements):
        if placement.is_shard():
            mesh = tensor.device_mesh
            return (placement.dim, mesh.get_group(mesh_dim), mesh.get_local_rank(mesh_dim),
                    mesh.size(mesh_dim))
    raise ValueError(f"no sharded dimension in {tensor.placements}")


def fsdp_chunk_span(length: int, index: int, size: int) -> Tuple[int, int]:
    """[start, stop) of chunk `index` of `size` as torch.chunk and FSDP2
    cut `length` rows: ceil(length / size) each, the last ones short or
    empty."""
    step = -(-length // size)
    start = min(index * step, length)
    return start, min(start + step, length)


def fsdp_gather(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of an FSDP2 DTensor as a plain tensor: each rank's dim-0
    chunk, padded to the longest, all-gathered over the fsdp group
    (parallel/distributed.py all_gather) and cut back (a collective: every
    rank of the group calls it). DTensor's own full_tensor() is not used:
    on the card's torch it crashes over gloo with CUDA tensors. A plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return tensor
    dim, group, _, size = _fsdp_shard(tensor)
    length = tensor.shape[dim]
    local = tensor.to_local()
    _, step = fsdp_chunk_span(length, 0, size)
    if local.shape[dim] < step:
        pad = list(local.shape)
        pad[dim] = step - local.shape[dim]
        local = torch.cat([local, local.new_zeros(pad)], dim=dim)
    return distributed.all_gather(local, group, dim).narrow(dim, 0, length)


def fsdp_local(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of fsdp_gather, with no collective: a copy of this
    rank's chunk of `full` as FSDP2 lays out the DTensor `like` (a DTensor
    of like's mesh and placements, on its device); a copy of `full` where
    `like` is plain."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return full.clone()
    dim, _, index, size = _fsdp_shard(like)
    start, stop = fsdp_chunk_span(full.shape[dim], index, size)
    local = full.narrow(dim, start, stop - start).to(like.device, copy=True)
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def gather_tensor(name: str, tensor: torch.Tensor, plans) -> torch.Tensor:
    """A tensor split by FSDP2 (fsdp_gather) and by `plans`
    (TensorParallel), all-gathered over the fsdp group, then over each
    plan's group that splits it, in order (a collective: every rank of
    the groups calls it)."""
    tensor = fsdp_gather(tensor)
    for lay in plans:
        rule = lay.rule(name)
        if rule is not None:
            tensor = distributed.all_gather(tensor, lay.group, rule[0])
    return tensor


def local_slice(name: str, tensor: torch.Tensor, plans) -> torch.Tensor:
    """The inverse of gather_tensor: this rank's slice of a full tensor."""
    for lay in plans:
        rule = lay.rule(name)
        if rule is not None:
            tensor = tensor.chunk(lay.size, rule[0])[lay.rank]
    return tensor


def gather_state_dict(
    state: Dict[str, torch.Tensor], plans: Optional[List[TensorParallel]],
) -> Dict[str, torch.Tensor]:
    """The inverse of shard_state_dict on a model's own state dict: each
    FSDP2 shard gathered, then each split tensor all-gathered over the
    groups of the plans it was laid out by (`layouts`; a collective: every
    rank of the groups calls it). The dict as it is for plain tensors and
    plans None."""
    return {name: gather_tensor(name, tensor, plans or []) for name, tensor in state.items()}


class VocabParallelEmbedding(nn.Embedding):
    """An embedding table's rows [start, start + rows) on this tp rank: a
    lookup of an id outside them gives zeros, and the ranks' lookups are
    summed (all-reduce forward, identity backward)."""

    def __init__(self, weight: nn.Parameter, start: int, group) -> None:
        super().__init__(weight.shape[0], weight.shape[1], _weight=weight.data)
        self.weight = weight
        self.start = start
        self.group = group

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        out = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        out = out.masked_fill(~inside[..., None], 0.0)
        return distributed.reduce_from_group(out, self.group)


def apply_tensor_parallel(model: nn.Module, mesh, rules: WrapPlan) -> nn.Module:
    """Lay `model` out by the rules' tp plan over the mesh's tp group, in
    place: each planned parameter becomes this rank's slice (a new
    Parameter), the row-parallel layers get `reduce_group` (their partial
    products are all-reduced before the bias), the embeddings become
    VocabParallelEmbedding, each TransformerBlock gets `tp_group` (its
    halves' inputs are copied to the group: identity forward, all-reduce
    backward), and a vocab-parallel head gives the root `vocab_shard`.
    The root gets `tensor_parallel`. Build the optimizer after this."""
    from ..ops.quant import QuantDenseGeneral, is_quantized

    size, rank, group = mesh.shape["tp"], mesh.coordinate["tp"], mesh.tp_group
    plan = rules.tp_int8 if is_quantized(model) else rules.tp
    # parallelize asks only for a plan the rules have; this guards the one
    # direct caller, models/gpt.py generate(mesh=, rules=)
    if not plan:
        raise NotImplementedError(f"tp={size} with {rules.name}: the rule set has no "
                                  "tensor-parallel plan" + (" for int8 weights" if rules.tp else ""))
    # the int8 twin's kernels, scales and biases are buffers
    tensors = list(model.named_parameters()) + [
        (f"{owner}.{attr}", buf) for owner, module in model.named_modules()
        if isinstance(module, QuantDenseGeneral) for attr, buf in module.named_buffers()]
    for name, tensor in tensors:
        rule = tp_rule(name, plan)
        if rule is None:
            continue
        dim, role = rule
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        local = _shard(tensor.detach(), dim, rank, size).clone()
        if isinstance(tensor, nn.Parameter):
            local = nn.Parameter(local)
        if role == "embed":
            parent_name, _, child = owner_name.rpartition(".")
            parent = model.get_submodule(parent_name)
            setattr(parent, child, VocabParallelEmbedding(local, rank * local.shape[0], group))
            continue
        setattr(owner, attr, local)
        if role == "row":
            owner.reduce_group = group
        if role == "head" and attr in ("weight", "kernel"):
            model.vocab_shard = VocabShard(rank * local.shape[dim], group)
        _fit_shapes(owner)
    for module in model.modules():
        if type(module).__name__ in ("TransformerBlock", "MoEBlock"):
            module.tp_group = group
    model.tensor_parallel = TensorParallel(group, rank, size, plan)
    _set_expert_groups(model, mesh)
    return model


def apply_expert_parallel(model: nn.Module, mesh, rules: WrapPlan) -> nn.Module:
    """Lay `model`'s experts out by the rules' ep layout, in place: each
    MoEMlp keeps this ep rank's e / ep experts (new Parameters) and sums
    its partial output over the ep group, or over ep x tp once the tp
    plan splits the experts too (_set_expert_groups). The root gets
    `expert_parallel`. Build the optimizer after this."""
    size, rank = mesh.shape["ep"], mesh.coordinate["ep"]
    for name, param in list(model.named_parameters()):
        rule = tp_rule(name, rules.ep)
        if rule is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner_name), attr,
                nn.Parameter(_shard(param.detach(), rule[0], rank, size).clone()))
    model.expert_parallel = TensorParallel(mesh.ep_group, rank, size, rules.ep)
    _set_expert_groups(model, mesh)
    return model


def _set_expert_groups(model: nn.Module, mesh) -> None:
    """Each MoEMlp's expert group and the index of its first local expert
    (models/moe.py MoEMlp.expert_parallel), by what the layouts split:
    the experts over ep, f over tp, or both (the mesh's ep x tp group)."""
    from ..models.moe import MoEMlp

    ep = getattr(model, "expert_parallel", None)
    tp = getattr(model, "tensor_parallel", None)
    if tp is not None and not any(role == "expert" for _, _, role in tp.plan):
        tp = None
    if ep is None and tp is None:
        return
    group = mesh.expert_group if ep is not None and tp is not None else (ep or tp).group
    for module in model.modules():
        if isinstance(module, MoEMlp):
            start = 0 if ep is None else ep.rank * module.expert_in.shape[0]
            module.expert_parallel(group, start)


def _fit_shapes(module: nn.Module) -> None:
    """A layer's shape attributes to its (local) weights: Linear's
    features, DenseGeneral's in/out shapes (whose head count then is the
    rank's)."""
    if isinstance(module, nn.Linear):
        module.out_features, module.in_features = module.weight.shape
    elif hasattr(module, "in_shape"):
        n_in = len(module.in_shape)
        module.in_shape = tuple(module.kernel.shape[:n_in])
        module.out_shape = tuple(module.kernel.shape[n_in:])




def parallelize(model: nn.Module, mesh, rules: WrapPlan, device: torch.device) -> nn.Module:
    """Wrap `model` (already on `device`) for the mesh; returns the module
    to call. First the ep layout (ep > 1) and the tp plan (tp > 1), where
    the rules have them, and the sequence shard (sp > 1); then the model
    itself under FSDP2 over those local tensors (`shard`, where the rules
    shard and the mesh's fsdp axis is > 1), else its DDP wrapper over the
    mesh's grad group, whose `.module` is the model, or the model itself
    where that group holds one rank. A model sharded already is returned
    as it is. Its TpuBatchNorms and MoE routers sync over the mesh's
    batch group (sync_batch_norm). A mesh with pp > 1 raises: the pipeline
    is its own model (models/moe_pipeline.py; as the reference's, it
    replicates its stages over fsdp, which only splits the batch)."""
    sync_batch_norm(model, mesh)
    if is_fully_sharded(model):
        return model
    if mesh.size("pp") > 1:
        raise ValueError(f"pp={mesh.size('pp')}: a pipeline runs models/moe_pipeline.py's "
                         "PipelinedMoELM, not a model wrapped for the mesh")
    if rules.ep and mesh.size("ep") > 1 and getattr(model, "expert_parallel", None) is None:
        apply_expert_parallel(model, mesh, rules)
    if rules.tp and mesh.shape["tp"] > 1 and getattr(model, "tensor_parallel", None) is None:
        apply_tensor_parallel(model, mesh, rules)
    if mesh.shape["sp"] > 1:
        # the rank's sequence shard: its positions start at seq_index x
        # the local length (models/gpt.py, models/bert.py)
        model.seq_index = mesh.coordinate["sp"]
    if shards_parameters(mesh, rules):
        return shard(model, mesh, rules)
    if mesh.grad_group is None:
        return model
    from torch.nn.parallel import DistributedDataParallel

    device_ids = None
    if device.type == "cuda":
        device_ids = [device.index if device.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(model, device_ids=device_ids, broadcast_buffers=False,
                                   process_group=mesh.grad_group)


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
    if group is None or dist.get_world_size(group) == 1:
        return
    for module in model.modules():
        if isinstance(module, (TpuBatchNorm, TopKRouter)):
            module.sync_group = group


def shard(model: nn.Module, mesh, rules: WrapPlan) -> nn.Module:
    """FSDP2 in place: `fully_shard` on each of the rules' blocks, then on
    the root, over the mesh's DeviceMesh (its fsdp axis shards, dp x sp
    replicates; a model laid out by the tp plan or the ep layout is
    sharded as its rank's local tensors). The parameters become DTensor
    shards, so an optimizer is built after this. Called by parallelize; a
    caller may also shard a model over a mesh whose fsdp axis is 1 (one
    rank), where sharding and replication compute the same step."""
    from torch.distributed.fsdp import fully_shard

    # innermost first: a unit excludes the parameters of the units inside it
    for module in reversed(list(model.modules())):
        if type(module).__name__ in rules.blocks:
            fully_shard(module, mesh=mesh.device_mesh)
    fully_shard(model, mesh=mesh.device_mesh)
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


def unwrap(module: nn.Module) -> nn.Module:
    """The model inside a DDP wrapper, else the module."""
    from torch.nn.parallel import DistributedDataParallel

    return module.module if isinstance(module, DistributedDataParallel) else module


def vocab_shard(module: nn.Module) -> Optional[VocabShard]:
    """The vocab split of a model's logits (apply_tensor_parallel), or None."""
    return getattr(unwrap(module), "vocab_shard", None)


def local_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), else the tensor."""
    from torch.distributed.tensor import DTensor

    return tensor.to_local() if isinstance(tensor, DTensor) else tensor
