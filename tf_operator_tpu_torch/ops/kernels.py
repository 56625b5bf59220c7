"""Build, load and launch the hand-written CUDA kernels.

Every source under `tf_operator_tpu_torch/csrc/` is compiled with nvcc
for `sm_90a` at first use, one nvcc per source and all started
together, and the objects are linked into one shared library with a
plain C interface, in `build/kernels/` at the root of the checkout
(named by a hash of all the sources and headers, so an edited one is
rebuilt),
and loaded with ctypes. Nothing here runs at import: the CPU tests
import this module on machines with no compiler and no card.

Each launcher below checks device, dtype, shape and contiguity, raises
on what the kernel does not take, allocates the outputs, launches on
PyTorch's current stream, raises if the launch returned an error, and
adds one to its entry in `LAUNCHES`. A run that wants to show that its
path went through the kernels resets the counts, runs, and reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PACKAGE / "csrc").glob("*.cuh")))
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# what the kernels are instantiated for; ops/flash_attention.py routes
# anything else to plain attention
HEAD_DIMS = (64, 128)
DTYPE = torch.bfloat16
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# conv3x3_fwd counts K4's forward and dx launches alike; conv3x3_dw
# counts one per weight gradient (its two passes are one launch here)
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
    "conv3x3_fwd": 0, "conv3x3_dw": 0,
}
# K4 computes a box of FWD_PIXELS output pixels (csrc/conv_bn.cu
# kFwdPixels) by 64 or 128 output channels per block
FWD_PIXELS = 128
# K5 sums the N*H*W pixels in patches of DW_PATCH (csrc/conv_bn.cu
# kDwPatch), split into runs of patches to fill the card's SMS in whole
# waves. The split count weighs waves against the partials' traffic:
# one block sustains about DW_BLOCK_FLOPS, and each split's f32 partial
# is written once and read once at about DW_BYTES_PER_S.
DW_PATCH = 112
SMS = 132
DW_BLOCK_FLOPS = 3.0e12
DW_BYTES_PER_S = 3.0e12

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels' sources into build/kernels/ unless a library
    built from the same sources is already there; returns its path."""
    digest = hashlib.sha256()
    for source in SOURCES + HEADERS:
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libkernels-{tag}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    work = BUILD_DIR / f"objs-{tag}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.monotonic()
    procs = []
    for source in SOURCES:
        obj = work / f"{source.stem}.o"
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(obj), str(source),
        ]
        procs.append((source, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    logs, failed = [], []
    for source, _, proc in procs:
        out, err = proc.communicate()
        logs.append(f"== {source.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{source.name} ({proc.returncode}):\n{err[-4000:]}")
    compile_seconds = time.monotonic() - start
    log = "\n".join(logs)
    (BUILD_DIR / f"build-{tag}.log").write_text(log)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True,
    )
    shutil.rmtree(work, ignore_errors=True)
    if link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    build_info.update(
        path=str(lib_path), seconds=time.monotonic() - start,
        compile_seconds=compile_seconds, cached=False, ptxas=log,
        sources=[str(source.relative_to(_PACKAGE.parent)) for source in SOURCES],
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        if torch.cuda.get_device_capability() != (9, 0):
            raise RuntimeError(
                "the kernels are built for sm_90a (Hopper); this card is "
                f"sm_{''.join(map(str, torch.cuda.get_device_capability()))}"
            )
        lib = ctypes.CDLL(str(build()))
        common = [_I, _P, _P, _P, _P]
        lib.flash_fwd.argtypes = common + [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
        lib.flash_bwd_dkv.argtypes = common + [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
        ]
        lib.flash_bwd_dq.argtypes = common + [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
        ]
        lib.conv3x3_fwd.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
        lib.conv3x3_dw.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [_P]
        for fn in (
            lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq,
            lib.conv3x3_fwd, lib.conv3x3_dw,
        ):
            fn.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().flash_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def _check_inputs(q, k, v, kv_mask, *more) -> Tuple[int, int, int, int]:
    """(B, H, Sq, Sk) after checking what the kernels take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype != DTYPE:
        raise ValueError(f"dtype {q.dtype} not supported ({DTYPE} only)")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid's 65535")
    tensors = [q, k, v, *more] + ([kv_mask] if kv_mask is not None else [])
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got {t.device}")
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise ValueError("q, k, v must share one dtype")
    if kv_mask is not None and (
        kv_mask.dtype != torch.float32 or kv_mask.shape != (b, sk)
    ):
        raise ValueError(f"kv_mask must be f32 [{b}, {sk}], got {kv_mask.shape}")
    return b, h, sq, sk


def _check_tma(**tensors: torch.Tensor) -> None:
    """K1-K3 read these through TMA tensor maps, which need 16-byte
    aligned base addresses."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd(q, k, v, kv_mask, causal: bool, scale: float):
    """K1. q [b, sq, h, d], k/v [b, sk, h, d], kv_mask [b, sk] f32 or
    None, all bf16 -> (out [b, sq, h, d] bf16, lse [b, h, sq] f32,
    out_f32: out before its rounding to bf16)."""
    b, h, sq, sk = _check_inputs(q, k, v, kv_mask)
    _check_tma(q=q, k=k, v=v)
    out = torch.empty_like(q)
    out_f32 = torch.empty_like(q, dtype=torch.float32)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.shape[-1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask), out.data_ptr(), out_f32.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, int(causal), scale, _stream(q.device),
        )
    _check("flash_fwd", rc)
    return out, lse, out_f32


def _check_bwd_stats(q, lse, delta, dout) -> None:
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{b}, {h}, {sq}]")


def flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal: bool, scale: float):
    """K2 -> (dk, dv) in bf16; lse and delta are f32 [b, h, sq]."""
    b, h, sq, sk = _check_inputs(q, k, v, kv_mask, dout, lse, delta)
    _check_bwd_stats(q, lse, delta, dout)
    _check_tma(q=q, k=k, v=v, dout=dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.shape[-1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, int(causal), scale,
            _stream(q.device),
        )
    _check("flash_bwd_dkv", rc)
    return dk, dv


def flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal: bool, scale: float):
    """K3 -> dq in bf16."""
    b, h, sq, sk = _check_inputs(q, k, v, kv_mask, dout, lse, delta)
    _check_bwd_stats(q, lse, delta, dout)
    _check_tma(q=q, k=k, v=v, dout=dout)
    dq = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.shape[-1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, sq, sk, int(causal), scale, _stream(q.device),
        )
    _check("flash_bwd_dq", rc)
    return dq


def _check_conv_inputs(x: torch.Tensor, other: torch.Tensor, other_name: str) -> None:
    """What K4 and K5 take: bf16 NHWC tensors, contiguous, 16-byte
    aligned, on one CUDA device, with channels in multiples of 64."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    for name, t in (("x", x), (other_name, other)):
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError("all tensors must be on one device")
        if t.dtype != DTYPE:
            raise ValueError(f"{name}: dtype {t.dtype} not supported ({DTYPE} only)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({'NHWC' if t.dim() == 4 else 'HWIO'})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.shape[3] % 64:
        raise ValueError(f"channels {x.shape[3]} not a multiple of 64")
    n, h, w, _ = x.shape
    if n * h * w >= 2**31:
        raise ValueError(f"N*H*W = {n * h * w} exceeds the kernels' int range")


class FwdPlan(NamedTuple):
    """K4's walk over the output: boxes of wb x hb pixels in each of nb
    images (wb * hb * nb == FWD_PIXELS), `boxes` of them over [N, H, W]
    (W fastest, then H, then N), each by Cout / bn blocks of bn output
    channels."""

    wb: int
    hb: int
    nb: int
    boxes: int
    bn: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pixel_box(n: int, h: int, w: int, pixels: int) -> Tuple[int, int, int]:
    """The box of wb x hb pixels in each of nb images, wb * hb * nb ==
    `pixels`, that covers [n, h, w] with the fewest padded pixels (ties:
    the widest rows, as TMA copies them)."""
    sizes = [d for d in range(1, pixels + 1) if pixels % d == 0]
    boxes = [(wb, hb, pixels // (wb * hb)) for wb in sizes for hb in sizes
             if (pixels // wb) % hb == 0]
    return min(boxes, key=lambda box: (
        _ceil(w, box[0]) * _ceil(h, box[1]) * _ceil(n, box[2]), -box[0], -box[1]))


@lru_cache(maxsize=None)
def fwd_plan(n: int, h: int, w: int, c: int, cout: int) -> FwdPlan:
    """The pixel box with the fewest padded pixels (_pixel_box), and 128
    output channels per block where Cout allows it, else 64."""
    wb, hb, nb = _pixel_box(n, h, w, FWD_PIXELS)
    boxes = _ceil(w, wb) * _ceil(h, hb) * _ceil(n, nb)
    return FwdPlan(wb, hb, nb, boxes, 128 if cout % 128 == 0 else 64)


def conv3x3_fwd(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K4. x [N, H, W, C] bf16 NHWC, kernel [3, 3, C, Cout] bf16 HWIO ->
    the SAME 3x3 stride-1 convolution [N, H, W, Cout] in bf16, summed
    in f32."""
    _check_conv_inputs(x, kernel, "kernel")
    n, h, w, c = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, c) or kernel.shape[3] % 64:
        raise ValueError(
            f"kernel must be [3, 3, {c}, Cout] with Cout a multiple of 64, "
            f"got {tuple(kernel.shape)}"
        )
    cout = kernel.shape[3]
    plan = fwd_plan(n, h, w, c, cout)
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.conv3x3_fwd(
            x.data_ptr(), kernel.data_ptr(), y.data_ptr(), n, h, w, c, cout,
            plan.wb, plan.hb, plan.nb, plan.bn, _stream(x.device),
        )
    _check("conv3x3_fwd", rc)
    return y


class DwPlan(NamedTuple):
    """K5's walk over the pixels: patches of wb x hb pixels in each of nb
    images (wb * hb * nb == DW_PATCH), `patches` of them over [N, H, W]
    (W fastest, then H, then N), summed in `splits` runs of `per_split`
    consecutive patches (the last run may be shorter)."""

    wb: int
    hb: int
    nb: int
    patches: int
    splits: int
    per_split: int


@lru_cache(maxsize=None)
def dw_plan(n: int, h: int, w: int, c: int, cout: int) -> DwPlan:
    """The patch box that covers [n, h, w] with the fewest padded pixels
    (_pixel_box), and the split count that minimises waves x patches per
    run plus the partials' traffic."""
    wb, hb, nb = _pixel_box(n, h, w, DW_PATCH)
    patches = _ceil(w, wb) * _ceil(h, hb) * _ceil(n, nb)
    bn = 128 if cout % 128 == 0 else 64
    tiles = _ceil(9 * (c // 64), 2) * (cout // bn)
    patch_s = 2 * DW_PATCH * 128 * bn / DW_BLOCK_FLOPS
    partial_s = 2 * 9 * c * cout * 4 / DW_BYTES_PER_S

    def cost(splits: int) -> float:
        per_split = _ceil(patches, splits)
        waves = _ceil(tiles * _ceil(patches, per_split), SMS)
        return waves * per_split * patch_s + splits * partial_s

    limit = min(patches, max(1, 8 * SMS // tiles))
    splits = min(range(1, limit + 1), key=lambda s: (cost(s), s))
    per_split = _ceil(patches, splits)
    return DwPlan(wb, hb, nb, patches, _ceil(patches, per_split), per_split)


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5. x [N, H, W, C] and g [N, H, W, Cout], bf16 NHWC -> the weight
    gradient [3, 3, C, Cout] in f32: split-K partials in a scratch
    buffer, then their sum in a fixed order."""
    _check_conv_inputs(x, g, "g")
    n, h, w, c = x.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (n, h, w) or g.shape[3] % 64:
        raise ValueError(f"g must be [{n}, {h}, {w}, Cout], Cout % 64 == 0, got {tuple(g.shape)}")
    cout = g.shape[3]
    plan = dw_plan(n, h, w, c, cout)
    partial = torch.empty((plan.splits, 3, 3, c, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, c, cout), dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.conv3x3_dw(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), n, h, w, c, cout,
            plan.wb, plan.hb, plan.nb, plan.splits, plan.per_split, _stream(x.device),
        )
    _check("conv3x3_dw", rc)
    return dw
