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
  (ops/flash_attention.py) plugs in.
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
    scale = torch.tensor(1.0 / math.sqrt(depth), dtype=query.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", query * scale.to(query.device), key)
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

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        kernel = self.kernel.to(self.dtype).reshape(fan_in, fan_out)
        y = x.to(self.dtype).reshape(*lead, fan_in) @ kernel
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
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        attend = self.attention_fn or dot_product_attention
        out = attend(self.query(x), self.key(x), self.value(x), mask)
        return self.attn_out(out)
