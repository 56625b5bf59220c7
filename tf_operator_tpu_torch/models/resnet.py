"""ResNet-50, the images/sec model. Counterpart of
tf_operator_tpu/models/resnet.py.

The reference's dtype policy: convolutions and BatchNorm compute in
the model dtype (bf16), BatchNorm parameters and statistics in f32
(models/norm.py), the spatial mean in the model dtype, logits from an
f32 Dense. The reference's `norm_dtype` (a BatchNorm compute dtype
other than the model's) and `norm_impl="flax"` have no caller here and
are not ported. Module and parameter names follow the reference's
param paths (stem, stem_bn, BottleneckBlock_{i}/Conv_0..2,
TpuBatchNorm_0..2, proj, proj_bn, Dense_0), so converted weights
(models/convert.py) load by name.

Layout. The public input is the reference's NHWC image batch. Inside,
activations are NCHW tensors in channels_last memory: cuDNN runs its
NHWC kernels on them, and `x.permute(0, 2, 3, 1)` hands the Hopper
conv kernels (ops/conv_bn.py) a contiguous NHWC view with no copy.
Convolution weights are OIHW for F.conv2d; PallasConv3x3 keeps the
reference's HWIO `kernel`.

Padding. flax's SAME pads (0, 1), not (1, 1), where a 3x3 window steps
by 2 over an even size: Conv_1 of the first block of stages 1-3 and the
stem max-pool (padded with -inf). `same_padding` computes flax's rule
and the asymmetric cases are padded explicitly.

`conv3_impl`: "xla" runs every conv through F.conv2d (cuDNN on the
card, the counterpart of XLA's conv emitter); "pallas" runs the
stride-1 3x3 bottleneck convs through K4/K5 (ops/conv_bn.py), as the
reference's "pallas". The reference's "pallas_interpret" has no
counterpart: a CPU tensor takes the kernels' plain versions by itself.
Parameters are drawn from the flax initializers' distributions with a
`torch.Generator`; they are not bit-equal to flax's.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import lecun_normal_
from ..ops.conv_bn import conv3x3_s1, supports
from .norm import TpuBatchNorm

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
CONV3_IMPLS = ("xla", "pallas")


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """flax/lax SAME padding (low, high) along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int], padding) -> Pads:
    if padding == "SAME":
        return tuple(
            same_padding(x.shape[2 + i], window[i], strides[i]) for i in range(2)
        )
    return tuple(tuple(p) for p in padding)


def conv2d(x: torch.Tensor, weight: torch.Tensor, strides, padding) -> torch.Tensor:
    """NCHW conv with flax's padding semantics: "SAME" or explicit
    [(lo, hi), (lo, hi)]; asymmetric padding goes through F.pad."""
    (hl, hh), (wl, wh) = _pads(x, weight.shape[2:], tuple(strides), padding)
    if hl == hh and wl == wh:
        return F.conv2d(x, weight, stride=tuple(strides), padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), weight, stride=tuple(strides))


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """flax nn.max_pool(x, (window, window), (stride, stride), "SAME"):
    padded with -inf."""
    (hl, hh), (wl, wh) = _pads(x, (window, window), (stride, stride), "SAME")
    x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class Conv(nn.Module):
    """flax nn.Conv(use_bias=False, dtype=dtype) on NCHW: OIHW `weight`
    in f32, input and weight cast to `dtype`, lecun_normal init."""

    def __init__(
        self, in_features: int, features: int, kernel_size: Tuple[int, int],
        strides: Tuple[int, int] = (1, 1), padding="SAME",
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        kh, kw = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.weight, in_features * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.strides, self.padding)


class PallasConv3x3(nn.Module):
    """3x3 conv whose stride-1 shapes run K4/K5 (ops/conv_bn.py), as the
    reference's PallasConv3x3 (models/resnet.py:30-56): the HWIO `kernel`
    is cast to the model dtype and, where `supports` holds, goes to
    conv3x3_s1 with the NHWC view of x; otherwise to the torch conv."""

    def __init__(
        self, in_features: int, features: int, strides: Tuple[int, int] = (1, 1),
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.strides = tuple(strides)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(3, 3, in_features, features))
        lecun_normal_(self.kernel, 9 * in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel.to(self.dtype)
        x = x.to(self.dtype)
        nhwc = x.permute(0, 2, 3, 1)
        if supports(nhwc.shape, kernel.shape, self.strides, self.dtype, x.device):
            return conv3x3_s1(nhwc, kernel).permute(0, 3, 1, 2)
        return conv2d(x, kernel.permute(3, 2, 0, 1), self.strides, "SAME")


class BottleneckBlock(nn.Module):
    def __init__(
        self, in_features: int, filters: int, strides: Tuple[int, int],
        conv3_impl: str = "xla", dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        conv = partial(Conv, dtype=dtype, generator=generator)
        norm = partial(TpuBatchNorm, dtype=dtype)
        out = filters * 4
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.TpuBatchNorm_0 = norm(filters)
        if conv3_impl == "xla":
            self.Conv_1 = conv(filters, filters, (3, 3), strides)
        else:
            self.Conv_1 = PallasConv3x3(
                filters, filters, strides, dtype=dtype, generator=generator
            )
        self.TpuBatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        # zero-init the last BN scale: residual branches start as identity
        self.TpuBatchNorm_2 = norm(out, zero_scale=True)
        self.proj = self.proj_bn = None
        if in_features != out or tuple(strides) != (1, 1):
            self.proj = conv(in_features, out, (1, 1), strides)
            self.proj_bn = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = torch.relu(self.TpuBatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.TpuBatchNorm_1(self.Conv_1(y)))
        y = self.TpuBatchNorm_2(self.Conv_2(y))
        if self.proj is not None:
            residual = self.proj_bn(self.proj(residual))
        return torch.relu(residual + y)


def normalize_uint8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 wire-format pixels [0, 255] -> about [-1, 1] in `dtype`,
    each step rounded to `dtype` as the reference's (x - 127.5) *
    (1 / 127.5) on weakly typed scalars (models/resnet.py:142-149)."""
    return (x.to(dtype) - 127.5) * torch.tensor(1.0 / 127.5, dtype=dtype, device=x.device)


class ResNet(nn.Module):
    def __init__(
        self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
        dtype: torch.dtype = torch.bfloat16, stem: str = "conv7", conv3_impl: str = "xla",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if conv3_impl not in CONV3_IMPLS:
            raise ValueError(f"conv3_impl {conv3_impl!r} not in {CONV3_IMPLS}")
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem {stem!r} not in ('conv7', 's2d')")
        self.dtype = dtype
        self.stem_kind = stem
        self.conv3_impl = conv3_impl
        if stem == "s2d":
            self.stem_s2d = Conv(
                12, width, (4, 4), padding=((2, 1), (2, 1)), dtype=dtype,
                generator=generator,
            )
        else:
            self.stem = Conv(
                3, width, (7, 7), (2, 2), padding=((3, 3), (3, 3)), dtype=dtype,
                generator=generator,
            )
        self.stem_bn = TpuBatchNorm(width, dtype=dtype)
        features, index = width, 0
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                filters = width * 2**stage
                self.add_module(f"BottleneckBlock_{index}", BottleneckBlock(
                    features, filters, strides, conv3_impl, dtype, generator,
                ))
                features, index = filters * 4, index + 1
        self.num_blocks = index
        self.Dense_0 = nn.Linear(features, num_classes)
        lecun_normal_(self.Dense_0.weight, features, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] images, f32 or uint8 -> f32 logits [N, classes].
        `self.training` picks batch or running BN statistics."""
        if x.dtype == torch.uint8:
            x = normalize_uint8(x, self.dtype)
        x = x.to(self.dtype).contiguous()
        if self.stem_kind == "s2d":
            x = self.stem_s2d(space_to_depth(x, 2).permute(0, 3, 1, 2))
        else:
            x = self.stem(x.permute(0, 3, 1, 2))
        x = max_pool_same(torch.relu(self.stem_bn(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet18ish = partial(ResNet, stage_sizes=(2, 2, 2, 2))  # small test variant


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, b*b*C]; channel order (u, v, c) with
    u/v the row/column offset inside the block, as conv7_to_s2d_kernel
    assumes."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def conv7_to_s2d_kernel(w7: torch.Tensor) -> torch.Tensor:
    """A 7x7/s2 stem kernel [7, 7, C, O] (HWIO) -> the equivalent 4x4/s1
    kernel [4, 4, 4C, O] over the 2x2 space-to-depth input padded
    [(2, 1), (2, 1)] (the reference's derivation, models/resnet.py:193-213)."""
    c_in, c_out = w7.shape[2], w7.shape[3]
    w4 = torch.zeros((4, 4, 4 * c_in, c_out), dtype=w7.dtype, device=w7.device)
    for a in range(7):
        m_a, u = divmod(a - 3, 2)
        for b in range(7):
            m_b, v = divmod(b - 3, 2)
            lo = (u * 2 + v) * c_in
            w4[m_a + 2, m_b + 2, lo:lo + c_in, :] = w7[a, b]
    return w4


def synthetic_batch(
    generator: torch.Generator, batch_size: int, image_size: int = 224,
    num_classes: int = 1000,
) -> Dict[str, torch.Tensor]:
    """Normal f32 images [B, S, S, 3] and labels in [0, num_classes)."""
    images = torch.randn(
        (batch_size, image_size, image_size, 3), generator=generator
    )
    labels = torch.randint(0, num_classes, (batch_size,), generator=generator)
    return {"image": images, "label": labels}


def synthetic_uint8_batch(
    seed: int, batch_size: int, image_size: int = 224, num_classes: int = 1000,
) -> Dict[str, torch.Tensor]:
    """The uint8 wire format, from numpy's PCG64 as the reference draws
    it (the same seed gives the reference's pixels and labels); the
    model normalizes on the device."""
    gen = np.random.default_rng(seed)
    images = gen.integers(0, 256, (batch_size, image_size, image_size, 3), np.uint8)
    labels = gen.integers(0, num_classes, (batch_size,), np.int32)
    return {"image": torch.from_numpy(images), "label": torch.from_numpy(labels).long()}
