"""Ring attention: exact attention over sequence shards. Counterpart of
tf_operator_tpu/parallel/ring_attention.py.

Each rank of the mesh's sp group holds one sequence shard of Q/K/V
([batch, seq / n, heads, head_dim], its heads under tp). K/V blocks
rotate around the ring (parallel/distributed.py ring_exchange: to rank
i + 1, from rank i - 1) while each rank folds the visiting block into an
f32 online-softmax state (o, m, l), as the reference's `_ring_shard`:
the block visiting at step t came from rank (i - t) % n, and under
`causal` the positions are offset by the ranks' shard starts. Like the
reference's jnp fold, this is plain torch: no kernel runs here.

The backward recomputes each block's scores (the reference's
jax.checkpoint of the fold) from the saved q, k, v, output and row
log-sum-exp: dQ accumulates locally, and each block's dK/dV partials
travel around the ring with it, one rotation more than the forward,
so they arrive at their owner. No [n, shard, shard] residual is saved:
memory stays O(s / n). Under causal, a block from a later shard than the
queries' is masked out entirely and is skipped, forward and backward
(its terms are exactly zero).
"""

from __future__ import annotations

import math

import torch

from . import distributed
from .compat import packed_only_attention

NEG_INF = -1e30


def _scores(q32, k_blk, me: int, src: int, shard: int, causal: bool) -> torch.Tensor:
    """[b, h, q_shard, k_shard] f32 scores of the scaled queries against
    a block from rank `src`, masked under causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
    if causal and src == me:
        pos = torch.arange(shard, device=s.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    return s


def _place(group):
    """(ring size, this rank's index); a ring of one without a group."""
    if group is None:
        return 1, 0
    return torch.distributed.get_world_size(group), torch.distributed.get_rank(group)


def _visible(me: int, src: int, causal: bool) -> bool:
    """Whether queries of shard `me` see any key of shard `src`."""
    return not causal or src <= me


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool):
        n, me = _place(group)
        b, shard, h, d = q.shape
        q32 = q.float() * (1.0 / math.sqrt(d))
        o = torch.zeros((b, h, shard, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, shard), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, shard), dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            src = (me - step) % n
            if _visible(me, src, causal):
                s = _scores(q32, k_blk, me, src, shard, causal)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
                m = m_new
            if step < n - 1:
                k_blk, v_blk = distributed.ring_exchange([k_blk, v_blk], group)
        l_safe = l.clamp_min(1e-30)
        out = (o / l_safe[..., None]).transpose(1, 2)  # [b, shard, h, d] f32
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = _place(group)
        b, shard, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        q32 = q.float() * scale
        do = dout.float()
        delta = (do * out).sum(dim=-1).transpose(1, 2)  # [b, h, shard]
        dq = torch.zeros_like(q32)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            src = (me - step) % n
            if _visible(me, src, causal):
                s = _scores(q32, k_blk, me, src, shard, causal)
                p = torch.exp(s - lse[..., None])
                dv_blk = dv_blk + torch.einsum("bhqk,bqhd->bkhd", p, do)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, v_blk.float())
                ds = p * (dp - delta[..., None])
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float()) * scale
                dk_blk = dk_blk + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            if step < n - 1:
                k_blk, v_blk, dk_blk, dv_blk = distributed.ring_exchange(
                    [k_blk, v_blk, dk_blk, dv_blk], group)
            elif n > 1:
                # one more hop: each block's partials reach their owner
                dk_blk, dv_blk = distributed.ring_exchange([dk_blk, dv_blk], group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None


def ring_attention(q, k, v, group, causal: bool = False) -> torch.Tensor:
    """Exact attention of this rank's [b, s / n, h, d] shards over the
    group's whole sequence (a collective: every rank of `group` calls
    it); with group None, the fold over the one local block."""
    return _RingAttention.apply(q, k, v, group, causal)


def make_ring_attention(mesh, causal: bool = False):
    """An attention_fn (query, key, value, mask) -> out for
    MultiHeadAttention: exact attention with the sequence sharded over the
    mesh's sp axis. A padding mask raises (packed batches only)."""
    group = mesh.sp_group

    def sharded(q, k, v):
        return ring_attention(q, k, v, group, causal)

    return packed_only_attention(sharded, "ring")
