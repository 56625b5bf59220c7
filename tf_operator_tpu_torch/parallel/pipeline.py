"""Pipeline parallelism: the GPipe schedule over the mesh's pp axis.
Counterpart of tf_operator_tpu/parallel/pipeline.py.

Each rank of the pp group holds one stage's layers (`stack_layers`
gives stage s its range of the L layers); microbatches stream through
the stages, each stage's output going to the next one point to point
(parallel/distributed.py stage_shift, the reference's lax.ppermute).
With S stages and M microbatches the schedule runs M + S - 1 ticks and
its bubble is (S - 1) / (M + S - 1).

The reference runs the schedule as one lax.scan under shard_map: every
stage computes at every tick, on garbage during its bubble ticks, and
masks the garbage out. Here a stage computes only on real data: at tick
t, stage s runs microbatch t - s where 0 <= t - s < M, and the ticks'
transfers name who sends and who receives, so no stage waits on a
transfer its neighbour skips. The outputs and the aux equal the
reference's.

The backward is autograd's: each tick's transfer is one node whose
backward sends the received tensor's gradient back and receives the
sent one's, and a token threads the nodes into one chain, so that every
rank runs them in reverse tick order. Every pp rank returns the last
stage's outputs (the reference's psum broadcast, :147-149), and its
backward gives the output gradient to the last stage once; x's gradient
(only the first stage consumes x) is summed over the pp group, so an
embedding in front of the pipeline gets the same gradient on every
stage.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple, Union

import torch

from . import distributed
from .mesh import axis_size


def stack_layers(layer_params: Sequence[Any], n_stages: int) -> List[List[Any]]:
    """The L per-layer params split into n_stages ranges of L / S, stage s
    holding layers [s * L/S, (s + 1) * L/S): the reference's [S, L/S, ...]
    stacking, a stage's row of it per entry."""
    n_layers = len(layer_params)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [list(layer_params[s * per:(s + 1) * per]) for s in range(n_stages)]


def _stage(layer_fn: Callable, stage_params: Sequence[Any], h: torch.Tensor,
           layer_aux: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """h through the stage's layers in order; (h, the layers' aux summed)."""
    aux = h.new_zeros((), dtype=torch.float32)
    for params in stage_params:
        out = layer_fn(params, h)
        if layer_aux:
            h, layer = out
            aux = aux + layer.float()
        else:
            h = out
    return h, aux


def pipeline_apply(
    layer_fn: Callable[[Any, torch.Tensor], Any],
    stage_params: Sequence[Any],
    x: torch.Tensor,
    *,
    mesh,
    n_microbatches: int,
    layer_aux: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x through every stage under the GPipe schedule.

    layer_fn(params, h) -> h applies ONE layer; this rank's stage runs it
    over stage_params (its stack_layers entry), in order. x: this rank's
    rows [batch, ...] (the mesh's dp x fsdp shard, the same on every pp
    rank; only the first stage reads it), and the output has its shape
    and dtype. mesh: parallel/mesh.py's TrainMesh, or None for one
    process (one stage).

    layer_aux=True: layer_fn returns (h, aux scalar), and this returns
    (out, aux): the per-layer aux summed over the layers, averaged over
    the microbatches and then over the data shards (dp x fsdp), each
    microbatch's means its own (the reference's mean of means). The
    value is the global average; its gradient reaches each rank's own
    microbatches only, so that the data-parallel mean of the gradients
    (PipelinedMoELM.sync_gradients) is the gradient of that average."""
    n_stages = axis_size(mesh, "pp")
    stage = 0 if mesh is None else mesh.index("pp")
    group = None if mesh is None else mesh.pp_group
    batch = x.shape[0]
    if batch % n_microbatches != 0:
        raise ValueError(f"local batch {batch} not divisible by {n_microbatches} microbatches")
    if group is not None:
        x, token = distributed.pipeline_start(x, group)
    x_mb = x.chunk(n_microbatches)
    outputs: List[torch.Tensor] = []
    aux_sum = x.new_zeros((), dtype=torch.float32)
    recv = None
    for t in range(n_microbatches + n_stages - 1):
        active = 0 <= t - stage < n_microbatches
        y = None
        if active:
            y, aux = _stage(layer_fn, stage_params, x_mb[t - stage] if stage == 0 else recv,
                            layer_aux)
            aux_sum = aux_sum + aux
            if stage == n_stages - 1:
                outputs.append(y)
        send = active and stage < n_stages - 1
        # the previous stage computed at this tick: its output arrives
        receive = stage > 0 and 0 <= t - stage + 1 < n_microbatches
        if send or receive:
            recv, token = distributed.stage_shift(token, y, x_mb[0] if receive else None,
                                                  group, send, receive)
    out = torch.cat(outputs) if outputs else torch.zeros_like(x)
    if group is not None:
        out = distributed.pipeline_end(out, token, group)
    if not layer_aux:
        return out
    if group is not None:
        aux_sum = distributed.reduce_from_group(aux_sum, group)
    aux_total = aux_sum / n_microbatches
    batch_group = None if mesh is None else mesh.batch_group
    if batch_group is not None:
        import torch.distributed as dist

        mean = distributed.all_reduce(aux_total.detach(), batch_group) / dist.get_world_size(
            batch_group)
        aux_total = aux_total + (mean - aux_total.detach())
    return out, aux_total
