"""BatchNorm with f32 statistics and per-channel math, activation-shaped
math in the activation dtype. Counterpart of
tf_operator_tpu/models/norm.py (TpuBatchNorm), not torch's BatchNorm2d,
whose running variance is the unbiased one:

    mean, mean_sq = sums of x and x^2 over N, H, W in f32, / count
    var   = max(mean_sq - mean^2, 0)       # biased, for both uses
    ra    = 0.9 * ra + 0.1 * stat          # training only
    inv   = rsqrt(var + eps) * scale       # [C], f32
    bias' = bias - mean * inv              # [C], f32
    y     = x * dtype(inv) + dtype(bias')  # activation dtype

Channels are dim 1 of an NCHW tensor (the port's ResNet keeps its
activations NCHW in channels_last memory, so this is the reference's
last axis). The square is taken in f32 inside the reduction
(vector_norm with dtype=f32), so no f32 copy of x is made. The affine
step is one addcmul, rounded once, as the reference's fused multiply-add.
`self.training` picks batch or running statistics.

Sync BatchNorm: where `sync_group` is set (parallel/sharding.py
parallelize sets it to the mesh's batch group when it spans more than
one rank), the training forward all-reduces the f32 sum, the sum of
squares and the count over that group before the mean and variance, so
the statistics, the normalised activations and the running statistics
are those of the global batch; under GSPMD the reference gets this for
free. The all-reduce is torch.distributed.nn's, which is
differentiable: its backward all-reduces the gradients of the sums,
without which the gradients would be those of a per-rank BatchNorm.
Unset (None), the statistics are this process's own.

FlaxBatchNorm is flax.linen.BatchNorm as the reference's ResNet builds it
under norm_impl="flax" (momentum 0.9, epsilon 1e-5, f32 parameters and
statistics), kept there for an A/B against TpuBatchNorm. Its math is
flax's, activation-shaped in f32:

    mean, mean_sq = means of x and x^2 over N, H, W, x cast to f32
    var   = max(mean_sq - mean^2, 0)
    ra    = 0.9 * ra + 0.1 * stat                   # training only
    y     = dtype(((f32(x) - mean) * (rsqrt(var + eps) * scale)) + bias)

It syncs its sums over `sync_group` as TpuBatchNorm does (the reference's
GSPMD mean over the sharded batch is the global batch's).
"""

from __future__ import annotations

import torch
from torch import nn


class TpuBatchNorm(nn.Module):
    def __init__(
        self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
        dtype: torch.dtype = torch.bfloat16, zero_scale: bool = False,
    ) -> None:
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32))
        self.sync_group = None  # a torch.distributed process group, or None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, 2, 3)
            count = x.numel() // x.shape[1]
            total = x.sum(dim=dims, dtype=torch.float32)
            total_sq = torch.linalg.vector_norm(
                x, 2, dim=dims, dtype=torch.float32
            ).square()
            if self.sync_group is not None:
                total, total_sq, count = _global_sums(total, total_sq, count, self.sync_group)
            mean = total / count
            var = torch.clamp(total_sq / count - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        fused_bias = self.bias - mean * inv
        shape = (1, -1, 1, 1)
        return torch.addcmul(
            fused_bias.to(self.dtype).view(shape), x.to(self.dtype),
            inv.to(self.dtype).view(shape),
        )


class FlaxBatchNorm(TpuBatchNorm):
    """flax.linen.BatchNorm's math (module docstring) with TpuBatchNorm's
    parameters, statistics and sync_group; `dtype` is the output's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.training:
            dims = (0, 2, 3)
            count = x.numel() // x.shape[1]
            total = xf.sum(dim=dims)
            total_sq = xf.square().sum(dim=dims)
            if self.sync_group is not None:
                total, total_sq, count = _global_sums(total, total_sq, count, self.sync_group)
            mean = total / count
            var = torch.clamp(total_sq / count - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def _global_sums(total: torch.Tensor, total_sq: torch.Tensor, count: int, group):
    """The sums and the count over `group`, in one differentiable
    all-reduce."""
    from torch.distributed.nn.functional import all_reduce

    channels = total.shape[0]
    local = torch.cat([total, total_sq, total.new_full((1,), float(count))])
    summed = all_reduce(local, group=group)
    return summed[:channels], summed[channels:2 * channels], summed[2 * channels]
