"""Attention ops. Counterpart of tf_operator_tpu/ops/attention.py.

- `dot_product_attention` keeps the reference's numerics: the scale is
  applied to q in the input dtype, scores are upcast to f32, masked
  scores take finfo(f32).min, and the softmax output is cast back to the
  input dtype before the second product.
- Projections keep flax DenseGeneral's layouts as the port's own
  parameters: q/k/v kernels [hidden, heads, head_dim] with biases
  [heads, head_dim]; attn_out kernel [heads, head_dim, hidden]. The
  parameter names (query/key/value/attn_out, kernel/bias) are the
  reference's, so converted weights load by path.
- `MultiHeadAttention.attention_fn` is the seam where flash attention
  (ops/flash_attention.py) and the sequence-parallel attentions
  (parallel/ring_attention.py, parallel/ulysses.py) plug in.
- Under a tensor-parallel plan (parallel/sharding.py) the projections
  hold this rank's heads, and the head count is the local weights':
  DenseGeneral reads its shapes from them. A row-parallel DenseGeneral
  (`reduce_group` set) all-reduces its partial product before it adds
  the bias, so the bias counts once.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

LECUN_TRUNC = 0.87962566103423978  # stddev of a unit normal cut at +-2


def lecun_normal_(
    t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax's lecun_normal: a normal cut at two standard deviations,
    scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNC
    with torch.no_grad():
        return nn.init.trunc_normal_(
            t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
        )


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention: [batch, len, heads, head_dim] inputs; a mask
    broadcasts against [batch, heads, q_len, k_len], truthy = attend."""
    depth = query.shape[-1]
    # the scale rounded to the query's dtype, made on its device (a fill,
    # not a copy from the host, so a CUDA graph can capture it)
    scale = torch.full((), 1.0 / math.sqrt(depth), dtype=query.dtype, device=query.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", query * scale, key)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(
            mask.bool(), scores, torch.finfo(torch.float32).min
        )
    weights = torch.softmax(scores, dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, value)


class DenseGeneral(nn.Module):
    """flax DenseGeneral over trailing axes: kernel in_shape + out_shape,
    bias out_shape, f32 parameters, computed in `dtype`."""

    def __init__(
        self, in_shape: Sequence[int], out_shape: Sequence[int],
        dtype: torch.dtype,
    ) -> None:
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))
        # set by parallel/sharding.py apply_tensor_parallel on a row-parallel layer
        self.reduce_group = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        kernel = self.kernel.to(self.dtype).reshape(fan_in, fan_out)
        y = x.to(self.dtype).reshape(*lead, fan_in) @ kernel
        if self.reduce_group is not None:
            from ..parallel.distributed import reduce_from_group

            y = reduce_from_group(y, self.reduce_group)
        y = y + self.bias.to(self.dtype).reshape(fan_out)
        return y.reshape(*lead, *self.out_shape)


def head_projection(
    hidden: int, num_heads: int, head_dim: int, dtype: torch.dtype
) -> DenseGeneral:
    """[..., hidden] -> [..., num_heads, head_dim] projection."""
    return DenseGeneral((hidden,), (num_heads, head_dim), dtype)


class MultiHeadAttention(nn.Module):
    def __init__(
        self, hidden: int, num_heads: int, head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        attention_fn: Optional[Callable] = None,
    ) -> None:
        super().__init__()
        self.query = head_projection(hidden, num_heads, head_dim, dtype)
        self.key = head_projection(hidden, num_heads, head_dim, dtype)
        self.value = head_projection(hidden, num_heads, head_dim, dtype)
        self.attn_out = DenseGeneral((num_heads, head_dim), (hidden,), dtype)
        self.attention_fn = attention_fn

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        attention_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """attention_fn, where given, attends in place of the module's
        own for this call (the KV-cached decode path of models/gpt.py)."""
        attend = attention_fn or self.attention_fn or dot_product_attention
        out = attend(self.query(x), self.key(x), self.value(x), mask)
        return self.attn_out(out)
