"""The training mesh. Counterpart of tf_operator_tpu/parallel/mesh.py.

The reference's mesh has six axes, outermost to innermost: data (dp),
pipeline (pp), fully-sharded data (fsdp), expert (ep), sequence (sp)
and tensor (tp). The port runs dp and fsdp: `build_mesh` gives a torch
DeviceMesh of shape (dp, fsdp) over the world, one process per device,
laid out in rank order, so rank r holds data shard r of a batch sharded
over (dp, fsdp). The other axes raise NotImplementedError, naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from . import distributed

MESH_AXES = ("dp", "fsdp")
# the axes the port does not run yet, and where ROADMAP places each
NOT_PORTED = {
    "pp": "pipeline parallel (ROADMAP queue 1, item 7)",
    "ep": "expert parallel (ROADMAP queue 1, item 7)",
    "sp": "sequence parallel, ring or Ulysses (ROADMAP queue 1, item 7)",
    "tp": "tensor parallel (ROADMAP queue 1, item 4)",
}


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


def build_mesh(
    config: Optional[MeshConfig] = None, device: Union[str, torch.device] = "cuda",
):
    """The (dp, fsdp) DeviceMesh over the world, on `device`'s type.

    The config is resolved against the world size (one device per
    process), so a shape that does not fit raises as the reference's
    does. None for a single process with no process group: its trainer
    runs the model unwrapped (distributed.initialize skips a
    single-process job)."""
    config = config or MeshConfig()
    for axis, where in NOT_PORTED.items():
        size = getattr(config, axis)
        if size != 1:
            raise NotImplementedError(f"{axis}={size}: {where} is not ported yet")
    dp, _, fsdp, _, _, _ = config.resolve(distributed.world_size())
    if not distributed.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (dp, fsdp), mesh_dim_names=MESH_AXES)


def data_shards(mesh) -> int:
    """How many ways a batch splits: dp * fsdp (1 without a mesh)."""
    return 1 if mesh is None else mesh.size()


def batch_group(mesh):
    """The process group of the ranks that split a batch (dp x fsdp):
    the group sync BatchNorm reduces over. build_mesh lays both axes over
    the whole world and refuses the others, so today it is the default
    group; a tensor-parallel axis (ROADMAP queue 1, item 4) is to stay
    out of it."""
    if tuple(mesh.mesh_dim_names) != MESH_AXES or mesh.size() != distributed.world_size():
        raise NotImplementedError(
            f"a batch group for mesh {mesh_summary(mesh)} over a world of "
            f"{distributed.world_size()}: only build_mesh's (dp, fsdp) over the world"
        )
    import torch.distributed as dist

    return dist.group.WORLD


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
    start = distributed.rank() * size if mesh is not None else 0
    return slice(start, start + size)


def mesh_summary(mesh) -> str:
    if mesh is None:
        return "dp=1xfsdp=1 (one process, no process group)"
    return "x".join(f"{axis}={mesh.size(i)}" for i, axis in enumerate(mesh.mesh_dim_names))


def add_mesh_flags(parser) -> None:
    """The token CLIs' (train/bert.py, train/gpt.py) mesh flags, as the
    reference's: --fsdp, and --tp, --sp and --sp-strategy, which
    `mesh_config` refuses until their ROADMAP items land."""
    parser.add_argument("--fsdp", type=int, default=1, help="FSDP2 shards over this many ranks")
    parser.add_argument("--tp", type=int, default=1, help=f"not ported: {NOT_PORTED['tp']}")
    parser.add_argument("--sp", type=int, default=1, help=f"not ported: {NOT_PORTED['sp']}")
    parser.add_argument("--sp-strategy", choices=["ring", "ulysses"], default=None,
                        help=f"not ported: {NOT_PORTED['sp']}")


def mesh_config(parser, args) -> MeshConfig:
    """The mesh the flags ask for; parser.error (exit 2) on a flag whose
    axis is not ported (any of --ep, --tp and --sp that the CLI has),
    naming its ROADMAP item."""
    for axis in ("ep", "tp", "sp"):
        size = getattr(args, axis, 1)
        if size != 1:
            parser.error(f"--{axis} {size}: {NOT_PORTED[axis]} is not ported yet")
    if getattr(args, "sp_strategy", None) is not None:
        parser.error(f"--sp-strategy {args.sp_strategy}: {NOT_PORTED['sp']} is not ported yet")
    return MeshConfig(dp=-1, fsdp=args.fsdp)
