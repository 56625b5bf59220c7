"""Build, load and launch the hand-written CUDA kernels.

The sources under `tf_operator_tpu_torch/csrc/` are compiled with nvcc
for `sm_90a` into a shared library with a plain C interface, at first
use, into `build/kernels/` at the root of the checkout (named by the
source's hash, so an edited source is rebuilt), and loaded with ctypes.
Nothing here runs at import: the CPU tests import this module on
machines with no compiler and no card.

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
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "flash_attention.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# what the kernels are instantiated for; ops/flash_attention.py routes
# anything else to plain attention
HEAD_DIMS = (64, 128)
DTYPE = torch.bfloat16
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}

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
    """Compile the kernels' source into build/kernels/ unless a library
    built from the same source is already there; returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libflash_attention-{digest}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    start = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - start
    (BUILD_DIR / f"build-{digest}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib_path)
    build_info.update(
        path=str(lib_path), seconds=seconds, cached=False,
        ptxas=proc.stderr,
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
        for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd(q, k, v, kv_mask, causal: bool, scale: float):
    """K1. q [b, sq, h, d], k/v [b, sk, h, d], kv_mask [b, sk] f32 or
    None, all bf16 -> (out [b, sq, h, d] bf16, lse [b, h, sq] f32,
    out_f32: out before its rounding to bf16)."""
    b, h, sq, sk = _check_inputs(q, k, v, kv_mask)
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
