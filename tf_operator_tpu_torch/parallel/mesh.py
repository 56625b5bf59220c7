"""The training mesh. Counterpart of tf_operator_tpu/parallel/mesh.py.

The reference's mesh has six axes, outermost to innermost: data (dp),
pipeline (pp), fully-sharded data (fsdp), expert (ep), sequence (sp)
and tensor (tp). `build_mesh` lays the world out over the six in rank
order, tp innermost as in the reference's AXES, one process per device,
and returns a `TrainMesh` holding the process groups each axis needs:

- tp: the ranks that hold one layer's shards (the Megatron plan's
  all-reduces, parallel/sharding.py);
- sp: the ranks that hold one row's sequence shards (ring and Ulysses
  attention, parallel/ring_attention.py, parallel/ulysses.py);
- pp: the ranks that hold one pipeline's stages (the activations'
  point-to-point sends, parallel/pipeline.py);
- ep: the ranks that hold one MoE layer's experts; expert: ep x tp, the
  ranks whose partial expert outputs are summed (models/moe.py MoEMlp);
- grad: dp x fsdp x sp, the ranks whose gradients of one parameter
  (shard) are reduced together: each pp, ep and tp rank reduces its own;
- batch: dp x fsdp, the ranks that split a batch's rows (sync
  BatchNorm, the MoE router, the pipeline's aux mean); pp, ep, tp and
  sp stay out of it, as the reference's batch_sharding (:116-128).

The serving mesh is another kind: `make_device_mesh` lays a
('batch', 'model') grid over devices of this process, which one engine
drives (serve/engine.py mesh_shape, models/gpt.py
ShardedPagedSlotDecodeStep). A caller may list the devices itself, and a
device may repeat: several shards then share one device, the port's
counterpart of the reference's virtual CPU devices.

Where fsdp > 1 (or pp = ep = sp = tp = 1) the mesh also holds the
DeviceMesh that FSDP2 shards over: this rank's (dp x sp, fsdp) slice of
one DeviceMesh over the world, whose outer dimension holds the pp, ep and
tp coordinates. FSDP2 shards each parameter over fsdp and replicates it
over dp x sp (HSDP), so its reduce-scatter and all-reduce together
average a gradient over the grad group; each pp, ep and tp coordinate
shards its own plain local tensors (parallel/sharding.py says why no
DTensor spans tp or ep).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from . import distributed

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")
# the dimensions of the DeviceMesh that FSDP2 shards over (_fsdp_mesh)
FSDP_MESH_DIMS = ("pp_ep_tp", "dp_sp", "fsdp")
SP_STRATEGIES = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Per-axis sizes; -1 on dp means "absorb the remaining devices"."""

    dp: int = -1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int, int]:
        fixed = self.pp * self.fsdp * self.ep * self.sp * self.tp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by pp*fsdp*ep*sp*tp={fixed}"
                )
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.pp}x{self.fsdp}x{self.ep}x{self.sp}x{self.tp}"
                f" != {n_devices} devices"
            )
        return (dp, self.pp, self.fsdp, self.ep, self.sp, self.tp)


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A built mesh: its shape over MESH_AXES, this rank's coordinate on
    each axis, and the process groups of the axes that span more than
    one rank (None where an axis has one rank: nothing to communicate).
    `device_mesh` is the (dp x sp, fsdp) DeviceMesh that FSDP2 shards
    over, built where fsdp > 1 or pp = ep = sp = tp = 1, None otherwise."""

    shape: Dict[str, int]
    coordinate: Dict[str, int]
    tp_group: object = None
    sp_group: object = None
    grad_group: object = None
    batch_group: object = None
    device_mesh: object = None
    pp_group: object = None
    ep_group: object = None
    expert_group: object = None

    @property
    def data_index(self) -> int:
        """Which of the dp x fsdp row shards this rank holds."""
        return self.coordinate["dp"] * self.shape["fsdp"] + self.coordinate["fsdp"]

    def size(self, axis: str) -> int:
        """The axis' size (1 for an axis the mesh was built without)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on the axis (0 where it has one rank)."""
        return self.coordinate.get(axis, 0)


def _rank_of(shape: Dict[str, int], coord: Dict[str, int]) -> int:
    rank = 0
    for axis in MESH_AXES:
        rank = rank * shape[axis] + coord[axis]
    return rank


def _groups_over(shape: Dict[str, int], axes: Tuple[str, ...]) -> List[List[int]]:
    """The rank lists of the groups that vary `axes` and hold the others
    fixed, each in rank order (so a group's rank i is index i along
    the varied axes)."""
    import itertools

    fixed = [a for a in MESH_AXES if a not in axes]
    groups = []
    for held in itertools.product(*(range(shape[a]) for a in fixed)):
        base = dict(zip(fixed, held))
        ranks = []
        for varied in itertools.product(*(range(shape[a]) for a in axes)):
            ranks.append(_rank_of(shape, {**base, **dict(zip(axes, varied))}))
        groups.append(sorted(ranks))
    return groups


def _my_group(shape: Dict[str, int], axes: Tuple[str, ...], own: bool = False):
    """This rank's group over `axes` (every rank creates every group, in
    one order, as new_group asks): WORLD where they span the world (a
    world of one included: DDP then wraps its one rank), unless `own`;
    None where they hold one rank of several; else a group of its own.
    `own` keeps the plans' exchanges (the ring's sends, the all-to-alls)
    off the process group of DDP's gradient all-reduces, which run
    asynchronously during the same backward."""
    import torch.distributed as dist

    size = 1
    for axis in axes:
        size *= shape[axis]
    if size == distributed.world_size() and not own:
        return dist.group.WORLD
    if size == 1:
        return None
    group, _ = dist.new_subgroups_by_enumeration(_groups_over(shape, axes))
    return group


def build_mesh(
    config: Optional[MeshConfig] = None, device: Union[str, torch.device] = "cuda",
) -> Optional[TrainMesh]:
    """The six-axis mesh over the world, on `device`'s type.

    The config is resolved against the world size (one device per
    process), so a shape that does not fit raises as the reference's
    does. None for a single process with no process group: its trainer
    runs the model unwrapped (distributed.initialize skips a
    single-process job)."""
    config = config or MeshConfig()
    dp, pp, fsdp, ep, sp, tp = config.resolve(distributed.world_size())
    if not distributed.is_initialized():
        return None
    shape = {"dp": dp, "pp": pp, "fsdp": fsdp, "ep": ep, "sp": sp, "tp": tp}
    rank = distributed.rank()
    coordinate = {}
    for axis in reversed(MESH_AXES):
        coordinate[axis] = rank % shape[axis]
        rank //= shape[axis]
    device_mesh = None
    if fsdp > 1 or pp * ep * sp * tp == 1:
        device_mesh = _fsdp_mesh(shape, torch.device(device).type)
    tp_group = _my_group(shape, ("tp",), own=True)
    sp_group = _my_group(shape, ("sp",), own=True)
    grad_group = _my_group(shape, ("dp", "fsdp", "sp"))
    batch_group = _my_group(shape, ("dp", "fsdp"))
    ep_group = _my_group(shape, ("ep",), own=True)
    # ep x tp is the tp group at ep 1 and the ep group at tp 1
    expert_group = (_my_group(shape, ("ep", "tp"), own=True) if ep > 1 and tp > 1
                    else ep_group or tp_group)
    return TrainMesh(
        shape=shape, coordinate=dict((a, coordinate[a]) for a in MESH_AXES),
        tp_group=tp_group, sp_group=sp_group, grad_group=grad_group,
        batch_group=batch_group, device_mesh=device_mesh,
        pp_group=_my_group(shape, ("pp",), own=True), ep_group=ep_group,
        expert_group=expert_group,
    )


def _fsdp_mesh(shape: Dict[str, int], device_type: str):
    """This rank's (dp x sp, fsdp) slice of a DeviceMesh over the world laid
    out as FSDP_MESH_DIMS: ranks that share pp, ep and tp coordinates form
    one (dp x sp, fsdp) grid, so FSDP2 shards each of those coordinates'
    local tensors over fsdp and replicates them over dp x sp. Every rank
    builds the whole mesh (its groups, in one order)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(distributed.world_size()).reshape([shape[a] for a in MESH_AXES])
    # (dp, pp, fsdp, ep, sp, tp) -> (pp, ep, tp, dp, sp, fsdp)
    grid = ranks.permute(1, 3, 5, 0, 4, 2).reshape(
        shape["pp"] * shape["ep"] * shape["tp"], shape["dp"] * shape["sp"], shape["fsdp"])
    return DeviceMesh(device_type, grid, mesh_dim_names=FSDP_MESH_DIMS)[FSDP_MESH_DIMS[1:]]


SERVE_AXES = ("batch", "model")


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A ('batch', 'model') grid of devices driven by one process:
    devices[b][m] holds the b-th batch shard's slot rows and the m-th
    model shard's heads (parallel/sharding.py SERVE_DECODE_RULES)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...] = SERVE_AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices), self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def local_devices(device: Union[str, torch.device, None] = None) -> List[torch.device]:
    """Every device of `device`'s type in this process: each CUDA card
    (cuda unless named), or the one CPU."""
    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def short_host_devices(device, want: int) -> List[torch.device]:
    """The devices the serving CLIs lay a mesh of `want` shards over:
    every device of `device`'s type, or, on a host with fewer, `device`
    itself `want` times (several shards on one device), as the
    reference's CLIs give a short host virtual CPU devices."""
    devs = local_devices(device)
    if len(devs) >= want:
        return devs
    from .._device import resolve_device

    return [resolve_device(device)] * want


def make_device_mesh(
    shape, axis_names: Tuple[str, ...] = SERVE_AXES, devices=None, device=None,
) -> ServeMesh:
    """The serving mesh (the reference's make_device_mesh, mesh.py:58-95):
    `shape` over `axis_names`, laid over `devices` in order (row-major),
    or by default over every device of `device`'s type (local_devices).
    A device may repeat in `devices`: several shards on one device.

    Device-count fallback, as the reference's: with FEWER devices than
    the shape asks for, the mesh collapses onto its first axis,
    (len(devices), 1); with more, only the first prod(shape) join it.
    The engine's engine_mesh_devices gauge shows the mesh that formed."""
    shape = tuple(int(dim) for dim in shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} axes for axis names {tuple(axis_names)}")
    if any(dim < 1 for dim in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    if len(shape) != 2:
        raise ValueError(f"the serving mesh has two axes, got {tuple(axis_names)}")
    devs = [torch.device(d) for d in devices] if devices is not None else local_devices(device)
    want = shape[0] * shape[1]
    if want > len(devs):
        shape = (len(devs), 1)
        want = len(devs)
    grid = tuple(tuple(devs[b * shape[1]:(b + 1) * shape[1]]) for b in range(shape[0]))
    return ServeMesh(devices=grid, axis_names=tuple(axis_names))


def axis_size(mesh: Optional[TrainMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def data_shards(mesh: Optional[TrainMesh]) -> int:
    """How many ways a batch's rows split: dp * fsdp (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape["dp"] * mesh.shape["fsdp"]


def grad_shards(mesh: Optional[TrainMesh]) -> int:
    """How many ranks reduce one parameter's gradient: dp * fsdp * sp,
    each holding its own part of the global batch's tokens."""
    return data_shards(mesh) * axis_size(mesh, "sp")


def batch_group(mesh: TrainMesh):
    """The process group of the ranks that split a batch's rows (dp x
    fsdp): the group sync BatchNorm and the MoE router reduce over, None
    where it holds one rank. The tp and sp axes stay out of it (their
    ranks see the same rows)."""
    return mesh.batch_group


def local_batch_size(mesh, global_batch: int) -> int:
    shards = data_shards(mesh)
    if global_batch % shards != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {shards} data shards"
        )
    return global_batch // shards


def local_rows(mesh, global_batch: int) -> slice:
    """This rank's rows of a batch of `global_batch` rows."""
    size = local_batch_size(mesh, global_batch)
    start = mesh.data_index * size if mesh is not None else 0
    return slice(start, start + size)


def local_positions(mesh, seq_len: int) -> slice:
    """This rank's [start, stop) of a sequence of `seq_len` positions
    under sp (the whole sequence without a mesh or with sp = 1)."""
    sp = axis_size(mesh, "sp")
    if seq_len % sp:
        raise ValueError(f"sequence length {seq_len} not divisible by sp={sp}")
    size = seq_len // sp
    start = mesh.coordinate["sp"] * size if mesh is not None else 0
    return slice(start, start + size)


def mesh_summary(mesh) -> str:
    """The mesh's size on each of MESH_AXES, as dp=2xpp=1x...xtp=1."""
    sizes = "x".join(f"{axis}={1 if mesh is None else mesh.size(axis)}" for axis in MESH_AXES)
    return sizes + (" (one process, no process group)" if mesh is None else "")


def add_mesh_flags(parser) -> None:
    """The token CLIs' (train/bert.py, train/gpt.py) mesh flags, as the
    reference's: --fsdp, --tp, --sp and --sp-strategy."""
    parser.add_argument("--fsdp", type=int, default=1, help="FSDP2 shards over this many ranks")
    parser.add_argument("--tp", type=int, default=1,
                        help="Megatron tensor parallel over this many ranks")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence parallel over this many ranks")
    parser.add_argument(
        "--sp-strategy", choices=SP_STRATEGIES, default="ring",
        help="sequence-parallel strategy when --sp > 1: ring (K/V blocks rotate around the "
        "sp ranks, O(s/n) memory) or ulysses (all-to-all head re-sharding, the flash "
        "kernels inside)",
    )


def mesh_config(args) -> MeshConfig:
    """The mesh the flags ask for (--fsdp, and --ep, --sp, --tp where the
    CLI has them), dp absorbing the rest of the world, as the reference's
    CLIs build it."""
    return MeshConfig(dp=-1, fsdp=args.fsdp, ep=getattr(args, "ep", 1),
                      sp=getattr(args, "sp", 1), tp=getattr(args, "tp", 1))


def sequence_attention(mesh, strategy: str = "ring", causal: bool = False,
                       flash: bool = False):
    """The attention_fn that --sp and --sp-strategy ask for (the
    reference CLIs' train/gpt.py:103-118): ring attention, or Ulysses
    with the flash route inside where `flash`; None where sp is 1."""
    if axis_size(mesh, "sp") == 1:
        return None
    if strategy == "ulysses":
        from .ulysses import make_ulysses_attention

        return make_ulysses_attention(mesh, causal=causal, flash=flash)
    from .ring_attention import make_ring_attention

    return make_ring_attention(mesh, causal=causal)
