"""Join the training world from the operator-injected environment.
Counterpart of tf_operator_tpu/parallel/distributed.py.

The operator injects every TPU replica's identity into its pods
(controller/cluster_spec.py set_tpu_env): TPU_WORKER_ID,
TPU_WORKER_HOSTNAMES, JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID. Every train CLI calls `initialize(device)` first, which
reads them and forms one torch.distributed world with no flags: rank =
the process id, world size = the number of processes, rendezvous over
tcp://<coordinator>. One process per pod, on the one device it was
given.

Backends: on a `cuda` device the world is "cpu:gloo,cuda:nccl", so
CUDA tensors go over NCCL and the small host collectives below (the
preemption latch, the barrier, all_reduce_scalars) over gloo, without
waiting for the card; on `cpu` it is gloo. A caller may name the
backend: two ranks on one card need "gloo", since NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Dict, Iterator, Mapping, Optional, Union

import torch
import torch.distributed as dist

from ..api.types import (
    ENV_COORDINATOR_ADDRESS,
    ENV_COORDINATOR_OVERRIDE,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_TPU_ACCELERATOR,
    ENV_TPU_TOPOLOGY,
    ENV_TPU_WORKER_HOSTNAMES,
    ENV_TPU_WORKER_ID,
)

logger = logging.getLogger("tf_operator_tpu_torch.distributed")

DEFAULT_COORDINATOR_PORT = 2222
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """The injected identity, parsed."""

    process_id: int = 0
    num_processes: int = 1
    coordinator_address: Optional[str] = None
    hostnames: tuple = ()
    topology: Optional[str] = None
    accelerator: Optional[str] = None

    @property
    def is_multi_host(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def read_process_env(environ: Optional[Mapping[str, str]] = None) -> ProcessEnv:
    """The reference's rules: JAX_PROCESS_ID wins over TPU_WORKER_ID; the
    world size defaults to the number of hostnames; the override remaps
    only the endpoint; the default coordinator is hostnames[0]:2222."""
    env = environ if environ is not None else os.environ
    hostnames = tuple(h for h in env.get(ENV_TPU_WORKER_HOSTNAMES, "").split(",") if h)
    process_id = int(env.get(ENV_PROCESS_ID, env.get(ENV_TPU_WORKER_ID, "0")))
    num_processes = int(env.get(ENV_NUM_PROCESSES, str(len(hostnames) or 1)))
    coordinator = env.get(ENV_COORDINATOR_OVERRIDE, env.get(ENV_COORDINATOR_ADDRESS))
    if coordinator is None and hostnames:
        coordinator = f"{hostnames[0]}:{DEFAULT_COORDINATOR_PORT}"
    return ProcessEnv(
        process_id=process_id,
        num_processes=num_processes,
        coordinator_address=coordinator,
        hostnames=hostnames,
        topology=env.get(ENV_TPU_TOPOLOGY),
        accelerator=env.get(ENV_TPU_ACCELERATOR),
    )


def backend_for(device: Union[str, torch.device], backend: Optional[str] = None) -> str:
    if backend is not None:
        return backend
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    device: Union[str, torch.device], backend: Optional[str] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> ProcessEnv:
    """init_process_group from the injected env (idempotent). A
    single-process job skips it, as the reference's does (the operator
    injects no cluster env for a local job)."""
    proc = read_process_env(environ)
    if not proc.is_multi_host or is_initialized():
        return proc
    if proc.coordinator_address is None:
        raise ValueError(
            f"{proc.num_processes} processes but no coordinator: set "
            f"{ENV_TPU_WORKER_HOSTNAMES}, {ENV_COORDINATOR_ADDRESS} or {ENV_COORDINATOR_OVERRIDE}"
        )
    backend = backend_for(device, backend)
    logger.info("init_process_group %s coordinator=%s process=%d/%d", backend,
                proc.coordinator_address, proc.process_id, proc.num_processes)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{proc.coordinator_address}",
        rank=proc.process_id, world_size=proc.num_processes,
    )
    return proc


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_coordinator() -> bool:
    return rank() == 0


def all_reduce_scalars(values: Dict[str, float], op: str = "sum") -> Dict[str, float]:
    """Each value reduced over the world ("sum" or "max"), as float64 on
    the host; the values themselves in a single process."""
    if world_size() == 1:
        return dict(values)
    names = sorted(values)
    packed = torch.tensor([float(values[n]) for n in names], dtype=torch.float64)
    dist.all_reduce(packed, op=_REDUCE_OPS[op])
    return dict(zip(names, packed.tolist()))


def barrier() -> None:
    """Every rank waits until all have arrived (a host all-reduce)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1))


def shutdown() -> None:
    """destroy_process_group, where one was formed."""
    if is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def world(device: Union[str, torch.device], backend: Optional[str] = None) -> Iterator[ProcessEnv]:
    """A CLI's run inside the world: initialize, log "process i/n", and
    on the way out destroy the process group that this formed (after a
    barrier when the run ended normally, so that no rank tears down while
    another still needs it; without one after an error, since a peer may
    be gone)."""
    owned = not is_initialized()
    proc = initialize(device, backend)
    logger.info("process %d/%d (coordinator=%s)", proc.process_id, proc.num_processes,
                proc.coordinator_address)
    try:
        yield proc
        barrier()
    finally:
        if owned:
            shutdown()


# -- the collectives of the tensor- and sequence-parallel plans ----------------
#
# parallel/sharding.py (Megatron tp), ring_attention.py and ulysses.py call
# these on plain local tensors; each differentiable one is an autograd
# Function with its backward. `group` is a process group of the mesh
# (parallel/mesh.py TrainMesh), never None: a plan inserts no collective on
# an axis of one rank.


def _host_staged(group, tensor: torch.Tensor) -> bool:
    """Whether a point-to-point exchange of `tensor` goes through host
    memory: over gloo, whose send/recv hand the transport the tensor's raw
    data pointer, so a CUDA tensor cannot be sent as it is (two ranks on
    one card run over gloo: NCCL refuses two ranks on one device). Gloo's
    all-reduce, all-gather and all-to-all take CUDA tensors themselves."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A reduced copy of `tensor` over `group` ("sum" or "max")."""
    out = tensor.clone()
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    return out


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(tensor: torch.Tensor, group, scatter_dim: int, gather_dim: int) -> torch.Tensor:
    """The tiled all-to-all (lax.all_to_all(tiled=True)): `tensor` split
    into n chunks along scatter_dim, chunk j sent to group rank j, and the
    chunks received concatenated along gather_dim in group-rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(tensor.chunk(n, dim=scatter_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


def ring_exchange(tensors, group) -> list:
    """Each tensor sent to the next rank of `group` ((i + 1) % n) and
    replaced by the previous rank's ((i - 1) % n): the ring's neighbour
    exchange, as lax.ppermute with perm [(i, i + 1 % n)]."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n)
    frm = dist.get_global_rank(group, (me - 1) % n)
    staged = _host_staged(group, tensors[0])
    sends = [t.detach().cpu() if staged else t.detach().contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    group (Megatron's f: the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's g: the output of
    a row-parallel layer, and the vocab-parallel embedding's)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAll(torch.autograd.Function):
    """all_to_all, whose backward is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.args = (group, gather_dim, scatter_dim)
        return all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, *ctx.args), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def all_to_all_grad(x: torch.Tensor, group, scatter_dim: int, gather_dim: int) -> torch.Tensor:
    """The differentiable all_to_all."""
    return _AllToAll.apply(x, group, scatter_dim, gather_dim)


# -- the pipeline's point-to-point transfers (parallel/pipeline.py) -----------
#
# A stage's activations go to the next stage of the pp group and its
# gradients come back. Each tick's transfers are one autograd node that
# posts its send and its receive together (batch_isend_irecv, as
# ring_exchange), so no order of blocking sends deadlocks; a 0-d token
# threads the ticks' nodes into one chain, so that every rank runs their
# backward passes in reverse tick order, each exactly once, whether or
# not its own outputs were used.


def _exchange(send: Optional[torch.Tensor], to: Optional[int], like: Optional[torch.Tensor],
              frm: Optional[int], group) -> Optional[torch.Tensor]:
    """Send `send` to group rank `to` and receive a tensor shaped as `like`
    from group rank `frm`, posted together; either may be None. Returns
    what was received (None where nothing was). Through host memory where
    _host_staged says so."""
    staged = _host_staged(group, send if send is not None else like)
    ops, recv = [], None
    if send is not None:
        payload = send.detach().cpu() if staged else send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, payload, dist.get_global_rank(group, to), group))
    if like is not None:
        recv = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recv is not None and staged:
        recv = recv.to(like.device)
    return recv


class _StageShift(torch.autograd.Function):
    """One tick of the pipeline: `y` (where `send`) to the next stage, and
    (where `like` is given) the previous stage's output received, shaped
    as `like`. Backward: the received tensor's gradient back to the
    previous stage, y's from the next. forward -> (received or an empty
    tensor, the next token)."""

    @staticmethod
    def forward(ctx, token, y, like, group, send, recv):
        me = dist.get_rank(group)
        ctx.group, ctx.me, ctx.send, ctx.recv = group, me, send, recv
        ctx.y_like = y.detach() if send else None
        ctx.recv_like = like if recv else None
        got = _exchange(y if send else None, me + 1, like if recv else None, me - 1, group)
        return (got if recv else token.new_zeros(0)), token.clone()

    @staticmethod
    def backward(ctx, grad_got, grad_token):
        grad_y = _exchange(grad_got if ctx.recv else None, ctx.me - 1,
                           ctx.y_like, ctx.me + 1, ctx.group)
        return grad_token, grad_y, None, None, None, None


class _PipelineStart(torch.autograd.Function):
    """The chain's first link: x as it is, and the token. Backward: x's
    gradient summed over the pp group (only the first stage consumes x),
    so every stage holds the first stage's gradient; it runs after every
    tick's, since the whole chain hangs from it."""

    @staticmethod
    def forward(ctx, x, token, group):
        ctx.group = group
        return x.view_as(x), token.clone()

    @staticmethod
    def backward(ctx, grad_x, grad_token):
        return all_reduce(grad_x.contiguous(), ctx.group), None, None


class _PipelineEnd(torch.autograd.Function):
    """The last stage's outputs on every stage: an all-reduce of the
    outputs (zeros on the other stages), the chain's token tied in.
    Backward: the gradient to the last stage's outputs once (every stage
    holds the same loss), the token's chain started."""

    @staticmethod
    def forward(ctx, outputs, token, group):
        return all_reduce(outputs.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, grad.new_zeros(()), None


def pipeline_start(x: torch.Tensor, group):
    """(x, token): the chain's start over the pp group. Where autograd
    records, the token requires a gradient whether or not x does, so that
    every stage's transfers are in the graph and run their backward."""
    token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    return _PipelineStart.apply(x, token, group)


def stage_shift(token: torch.Tensor, y: Optional[torch.Tensor], like: Optional[torch.Tensor],
                group, send: bool, recv: bool):
    """(received, token): one tick's transfer; see _StageShift."""
    return _StageShift.apply(token, y, like, group, send, recv)


def pipeline_end(outputs: torch.Tensor, token: torch.Tensor, group) -> torch.Tensor:
    return _PipelineEnd.apply(outputs, token, group)
