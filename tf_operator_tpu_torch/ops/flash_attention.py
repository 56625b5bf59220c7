"""Flash attention: the Hopper kernels K1-K3 behind one autograd Function.

Counterpart of tf_operator_tpu/ops/pallas/flash_attention.py. The
kernels live in csrc/flash_attention.cu and are launched through
ops/kernels.py; beside them, `flash_forward_reference` and
`flash_backward_reference` compute the same functions in plain f32
PyTorch, with the same -1e30 masking and lse clamp. A tensor on the CPU
goes to those plain versions (that is how the CPU tests run); a CUDA
tensor goes to the kernels, or the launch raises. There is no fallback
from a kernel to its plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import kernels

NEG_INF = -1e30


def _scores_mask(
    sq: int, sk: int, kv_mask: Optional[torch.Tensor], causal: bool,
    device: torch.device,
) -> Optional[torch.Tensor]:
    """[b or 1, 1, sq, sk] bool, True = attend, or None."""
    keep = None
    if causal:
        q_pos = torch.arange(sq, device=device)[:, None]
        k_pos = torch.arange(sk, device=device)[None, :]
        keep = (q_pos >= k_pos)[None, None]
    if kv_mask is not None:
        valid = (kv_mask > 0)[:, None, None, :]
        keep = valid if keep is None else keep & valid
    return keep


def _forward_f32(q, k, v, kv_mask, causal, scale):
    """(out in f32, lse f32 [b, h, sq]); scale on q in f32 before the
    product, as K1 applies it."""
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    keep = _scores_mask(q.shape[1], k.shape[1], kv_mask, causal, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float())
    return out, (m + torch.log(l_safe))[..., 0]


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor], causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. q [b, sq, h, d], k/v [b, sk, h, d], kv_mask
    [b, sk] f32 or None -> (out in q's dtype, lse [b, h, sq] f32)."""
    out, lse = _forward_f32(q, k, v, kv_mask, causal, scale)
    return out.to(q.dtype), lse


def _backward_probs(q, k, v, kv_mask, dout, lse, delta, causal, scale):
    """p = exp(s - lse) and ds = p * (dO v^T - delta), f32 [b, h, sq, sk],
    with the scale on the scores as K2 and K3 apply it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _scores_mask(q.shape[1], k.shape[1], kv_mask, causal, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_backward_dkv_reference(
    q, k, v, kv_mask, dout, lse, delta, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 -> (dk, dv) in k's dtype."""
    p, ds = _backward_probs(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_reference(
    q, k, v, kv_mask, dout, lse, delta, causal: bool, scale: float,
) -> torch.Tensor:
    """Plain version of K3 -> dq in q's dtype."""
    _, ds = _backward_probs(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def flash_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor], dout: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K3 -> (dq, dk, dv) in the inputs' dtype.
    lse and delta are f32 [b, h, sq]."""
    args = (q, k, v, kv_mask, dout, lse, delta, causal, scale)
    dk, dv = flash_backward_dkv_reference(*args)
    return flash_backward_dq_reference(*args), dk, dv


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 as [b, h, sq]; a plain torch op, as it is
    outside the kernels in the reference (flash_attention.py:399-402).
    Unlike the reference, `out` is K1's output before its rounding to
    the input dtype: with a bf16 O, delta differs from the sum_k p dp
    that K2/K3 compute in f32, ds rows stop summing to zero, and dQ/dK
    pick up an error along the mean key/query, large where O is large
    against v_k - O (tests/test_torch_flash_attention.py holds both
    formulations against f32)."""
    d = (dout.float() * out.float()).sum(dim=-1)  # [b, sq, h]
    return d.transpose(1, 2).contiguous()


def flash_forward(q, k, v, kv_mask, causal: bool, scale: float):
    """K1 for CUDA tensors, its plain version for CPU tensors ->
    (out in q's dtype, lse, out in f32)."""
    if q.device.type == "cpu":
        out_f32, lse = _forward_f32(q, k, v, kv_mask, causal, scale)
        return out_f32.to(q.dtype), lse, out_f32
    return kernels.flash_fwd(q, k, v, kv_mask, causal, scale)


def flash_backward(q, k, v, kv_mask, out_f32, lse, dout, causal: bool, scale: float):
    """K2 then K3 for CUDA tensors, their plain version for CPU tensors
    -> (dq, dk, dv). `out_f32` is the forward's output in f32."""
    delta = _delta(out_f32, dout)
    if q.device.type == "cpu":
        return flash_backward_reference(
            q, k, v, kv_mask, dout, lse, delta, causal, scale
        )
    dk, dv = kernels.flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    dq = kernels.flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Mirror of _make_flash_vjp (flash_attention.py:504-532): saves q, k,
    v, the mask, out (in f32, see _delta) and lse; the mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: float):
        out, lse, out_f32 = flash_forward(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, out_f32, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out_f32, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(
            q, k, v, kv_mask, out_f32, lse, dout.contiguous(), ctx.causal, ctx.scale
        )
        return dq, dk, dv, None, None, None


def supports(seq_q: int, seq_kv: int, head_dim: int) -> bool:
    """Shapes the Hopper kernels take. They mask the ragged last tile
    themselves, so any sequence length works (the TPU kernel's
    multiple-of-128 rule was a Mosaic tiling constraint); head_dim is
    one the kernels are instantiated for: 64 (BERT-base) or 128
    (BERT_BASE_WIDE, GPT). The kernels take bf16 only; `flash_attention`
    routes a CUDA tensor of another dtype to plain attention as it
    routes a shape this refuses. On the CPU the kernels' plain versions
    stand in at any dtype, which is how the f32 tests hold this route
    against the reference."""
    return seq_q >= 1 and seq_kv >= 1 and head_dim in kernels.HEAD_DIMS


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Drop-in for ops.attention.dot_product_attention ([batch, seq,
    heads, head_dim] in and out), routed as the reference routes
    (flash_attention.py:605-623):

    - mask None: dense attention in the kernels;
    - a key-padding mask of shape [batch, 1, 1, seq_kv] (truthy =
      attend): in the kernels, as a [batch, seq_kv] f32 validity row
      shared by the heads;
    - any other mask, a shape `supports()` refuses, or a CUDA tensor
      that is not bf16: the plain `dot_product_attention`, with
      causality kept.
    """
    from .attention import dot_product_attention

    b, sq, h, d = query.shape
    sk = key.shape[1]
    kv_mask = None
    if mask is not None and mask.dim() == 4 and tuple(mask.shape) == (b, 1, 1, sk):
        kv_mask = mask[:, 0, 0, :]
    eligible = supports(sq, sk, d) and (
        query.device.type == "cpu" or query.dtype == kernels.DTYPE
    )
    if (mask is not None and kv_mask is None) or not eligible:
        if causal:
            causal_mask = (
                torch.arange(sq, device=query.device)[:, None]
                >= torch.arange(sk, device=query.device)[None, :]
            )[None, None]
            mask = causal_mask if mask is None else mask.bool() & causal_mask
        return dot_product_attention(query, key, value, mask)
    if kv_mask is not None:
        kv_mask = (kv_mask > 0).float().contiguous()
    return FlashAttentionFunction.apply(
        query.contiguous(), key.contiguous(), value.contiguous(), kv_mask,
        causal, 1.0 / math.sqrt(d),
    )
