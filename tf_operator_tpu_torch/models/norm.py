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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, 2, 3)
            count = x.numel() // x.shape[1]
            total = x.sum(dim=dims, dtype=torch.float32)
            total_sq = torch.linalg.vector_norm(
                x, 2, dim=dims, dtype=torch.float32
            ).square()
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
