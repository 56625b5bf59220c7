"""3x3 stride-1 convolution on the Hopper kernels K4 and K5, behind one
autograd Function.

Counterpart of tf_operator_tpu/ops/pallas/conv_bn.py. The kernels live
in csrc/conv_bn.cu and are launched through ops/kernels.py: K4 is the
implicit-GEMM forward, also run for dx on the cotangent with the
flipped, transposed weights, and K5 the weight gradient. Beside them,
`conv3x3_fwd_plain` and `conv3x3_dw_plain` compute the same functions
in plain PyTorch as nine shifted taps summed in f32. A tensor on the
CPU goes to those plain versions (that is how the CPU tests run); a
CUDA tensor goes to the kernels, or the launch raises. There is no
fallback from a kernel to its plain version.

Layouts are the reference's at this module's public functions: x
[N, H, W, C] (NHWC), kernel [3, 3, C, Cout] (HWIO).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from . import kernels

Shape = Sequence[int]


def supports(
    x_shape: Shape, w_shape: Shape, strides: Sequence[int],
    dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> bool:
    """Shapes and types conv3x3_s1 takes: a 3x3 kernel, stride 1, C and
    Cout multiples of 64 (conv_bn.py:52-77). Any N: the kernels mask the
    ragged last tile, so the reference's n % images_per_program rule and
    its VMEM budget, both TPU artifacts, are not carried over. The
    kernels take bf16; on the CPU the plain versions stand in at any
    float dtype (how the f32 tests hold this route against the
    reference), while a CUDA tensor of another dtype is for the caller
    to route to the torch conv, as models/resnet.py PallasConv3x3 does."""
    if tuple(strides) != (1, 1) or tuple(w_shape[:2]) != (3, 3):
        return False
    if len(x_shape) != 4 or w_shape[2] != x_shape[3]:
        return False
    if x_shape[3] % 64 or w_shape[3] % 64:
        return False
    if torch.device(device).type == "cpu":
        return dtype.is_floating_point
    return dtype == kernels.DTYPE


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or x's dtype where it is wider."""
    return torch.promote_types(x.dtype, torch.float32)


def _taps(x: torch.Tensor):
    """The nine shifted [N*H*W, C] windows of zero-padded x, in f32 (or
    wider), in (dy, dx) order."""
    n, h, w, c = x.shape
    xp = F.pad(x.to(_acc_dtype(x)), (0, 0, 1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c)


def conv3x3_fwd_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: nine [M, C] @ [C, Cout] taps over the
    zero-padded x, summed in f32 (or x's dtype where it is wider),
    returned in x's dtype."""
    n, h, w, _ = x.shape
    acc = None
    for dy, dx, window in _taps(x):
        tap = window @ kernel[dy, dx].to(window.dtype)
        acc = tap if acc is None else acc + tap
    return acc.reshape(n, h, w, kernel.shape[3]).to(x.dtype)


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: dw[dy, dx] = x_shift(dy, dx)^T @ g over all
    N*H*W pixels, f32 [3, 3, C, Cout] (or x's dtype where it is wider)."""
    c, cout = x.shape[3], g.shape[3]
    g2 = g.to(_acc_dtype(x)).reshape(-1, cout)
    taps = [window.T @ g2 for _, _, window in _taps(x)]
    return torch.stack(taps).reshape(3, 3, c, cout)


def conv3x3_fwd(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K4 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_fwd_plain(x, kernel)
    return kernels.conv3x3_fwd(x, kernel)


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    return kernels.conv3x3_dw(x, g)


class Conv3x3Function(torch.autograd.Function):
    """Mirror of conv3x3_s1's custom_vjp (conv_bn.py:131-223): saves x
    and the kernel; dx is the forward on the cotangent (cast to x's
    dtype) with the kernel flipped on (0, 1) and transposed on (2, 3),
    and dw is K5's f32 result cast to the kernel's dtype."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return conv3x3_fwd(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        k_flip = kernel.flip(0, 1).transpose(2, 3).to(x.dtype).contiguous()
        dx = conv3x3_fwd(g, k_flip)
        dw = conv3x3_dw(x, g).to(kernel.dtype)
        return dx, dw


def conv3x3_s1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 stride-1 NHWC convolution on K4/K5. x [N, H, W, C]
    (contiguous NHWC on the card), kernel [3, 3, C, Cout] ->
    [N, H, W, Cout] in x's dtype."""
    return Conv3x3Function.apply(x, kernel.contiguous())
