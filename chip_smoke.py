#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero, printing no result:

1. device - a CUDA card is present; its name and power limit.
2. build - the Hopper kernels built from csrc/ with nvcc (seconds,
   registers and spills per kernel).
3. kernel_check - K1 (forward), K2 (dK/dV), K3 (dQ) against their plain
   PyTorch versions in bf16 on the card, with and without the
   key-padding mask, causal and not, at (b=4, h=12, d=64) and (b=4,
   h=6, d=128), each at seq 512 and at the ragged seq 333 (a last tile
   that TMA zero-fills); at every shape also the common-part case (v =
   4 + 0.05 noise): dq, dk, dv within 1% of the f32 gradients.
4. kernel_times - at one BERT-base layer's shape, each kernel against
   its plain version once more, then the median ms (and TFLOP/s) of each
   kernel, its plain version and F.scaled_dot_product_attention, with
   the bound computed from those inputs.
5. train - BERT-base MLM at full width (12 x 768, 12 x 64 heads, vocab
   30522, seq 512, batch 32, AdamW wd 0.01, --flash --packed) through
   the CLI's run(); launch counters must equal 12 per forward (K1) and
   per backward (K2, K3) pass. train_plain: the same run on the plain
   attention path.
6. profile - device time of two flash training steps by kernel.
7. plain_parity - one Trainer.step from the same seed through the flash
   kernels, the plain bf16 path and an f32 plain path, packed and
   unpacked (the unpacked one runs the in-kernel mask path inside the
   model): losses and gradients within the stated tolerances.
8. conv_check - K4 (forward), K4 as dx (flipped, transposed kernel) and
   K5 (dW) against their plain versions in bf16 on the card, at the
   four ResNet-50 stage shapes with N=8, at two C != Cout shapes and at
   three ragged ones (H*W = 81, not a multiple of 16; K4 boxes that pad
   N and W).
9. conv_times - at each stage shape at N=256 (the bench's batch), each
   kernel against its plain version once more, then the median ms of
   each kernel, its plain version and the cuDNN call that computes the
   same function (F.conv2d for the forward and for dx on the flipped,
   transposed kernel, torch.nn.grad.conv2d_weight for dW; dx's
   torch.nn.grad.conv2d_input beside it), with the bound computed from
   those inputs; K4's plan (pixel box, tile width) and the L2 request
   rate its plan implies (modelled bytes over measured time).
10. resnet_train - ResNet-50 (stage sizes 3, 4, 6, 3, width 64, 1000
   classes, 224x224, bf16, batch 256, SGD 0.1 momentum 0.9,
   --conv3-impl pallas) through the CLI's run(); launch counters must
   equal 13 K4 launches per forward and per backward pass and 13 K5
   launches per backward pass. resnet_train_xla: the same run with
   --conv3-impl xla (cuDNN for every conv).
11. resnet_profile - device time of two ResNet-50 steps by kernel and by
   kind of kernel, pallas and xla.
12. resnet_parity - one Trainer.step from the same weights and batch
   (N=32, 224x224) through K4/K5, the torch conv in bf16, and the torch
   conv in f32 with TF32 off: losses, gradients and BN running
   statistics within the stated tolerances, then one evaluate.
Then the kernel summary line, the nvidia-smi line, and the result line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 outputs of a kernel and its plain version both round an f32
# result once: allow 2 bf16 ulps (2 * 2^-8) of the largest magnitude
KERNEL_RTOL = 2 * 2.0**-8
# K1's f32 output against the plain version's f32 output. K1 feeds P to
# P.V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), which keep
# p to within 2^-18 of itself; O is a convex combination of v rows, so
# that moves it by at most 2^-18 * max|v|. Beside it, f32 sums in another
# order: 1e-5 of the largest magnitude.
OUT_F32_P_RTOL = 2.0**-18
OUT_F32_RTOL = 1e-5
# the common-part case (v = 4 + 0.05 noise, where O is large against
# v_k - O): K1 -> delta -> K2, K3 in bf16, each of dq, dk, dv within this
# relative L2 distance of the f32 plain gradients
COMMON_GRAD_RTOL = 1e-2
# flash vs plain attention inside BERT-base in bf16: the plain path runs
# both products in bf16, the kernels in f32, so logits differ by bf16
# roundings; the f32 loss (about ln 30522 = 10.3) may differ by this
LOSS_ATOL = 2e-2
# gradients: relative L2 distance to the f32 step, flash route over
# plain bf16 route, for each parameter (distances below GRAD_FLOOR
# count as GRAD_FLOOR)
GRAD_RATIO = 1.5
GRAD_FLOOR = 1e-2
MAIN_SHAPE = (32, 512, 12, 64)  # one BERT-base layer at the bench's batch
# seq 333 is not a multiple of the kernels' 64- or 128-row tiles
CHECK_SHAPES = ((4, 512, 12, 64), (4, 512, 6, 128), (4, 333, 12, 64), (4, 333, 6, 128))
LAYERS = 12
FLASH_SOURCE = "tf_operator_tpu_torch/csrc/flash_attention.cu"
CONV_SOURCE = "tf_operator_tpu_torch/csrc/conv_bn.cu"
REPLACES = {
    "flash_fwd": "tf_operator_tpu/ops/pallas/flash_attention.py:88",
    "flash_bwd_dkv": "tf_operator_tpu/ops/pallas/flash_attention.py:250",
    "flash_bwd_dq": "tf_operator_tpu/ops/pallas/flash_attention.py:324",
    "conv3x3_fwd": "tf_operator_tpu/ops/pallas/conv_bn.py:91",
    "conv3x3_dw": "tf_operator_tpu/ops/pallas/conv_bn.py:144",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
CONV_KERNELS = ("conv3x3_fwd", "conv3x3_dw")
# ResNet-50's stride-1 3x3 convs: (spatial size, channels, how many per
# pass) at stage sizes 3, 4, 6, 3 (the first block of stages 1-3 is
# stride 2 and takes the torch conv)
CONV_STAGES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
CONVS_PER_PASS = sum(count for _, _, count in CONV_STAGES)
RESNET_BATCH = 256  # the bench's per-chip batch (model_benches.py:97)
RESNET_IMAGE = 224
CONV_CHECK_N = 8
# C != Cout cases, from tests/test_attention.py TestPallasConv, and
# ragged ones: 9x9 images that K5's 112-pixel patches cover with
# padding, and two whose K4 boxes pad N and W (8x8x2 boxes over 3 7x7
# images; a 32x4 box over one 3x11 image)
CONV_EXTRA_CASES = (
    ((2, 8, 8, 128), 64), ((2, 4, 4, 256), 512), ((3, 9, 9, 64), 128),
    ((3, 7, 7, 512), 256), ((1, 3, 11, 512), 64),
)
# K5's f32 dW sums N*H*W products in another order than the plain
# version's f32 matmul: allow 1e-4 of the largest magnitude
DW_RTOL = 1e-4
RESNET_PARITY_BATCH = 32
# device time by kind of kernel in resnet_profile, first match wins
# (substrings of the lower-cased kernel name)
PROFILE_CATEGORIES = (
    ("conv3x3 (K4/K5)", ("conv3x3_",)),
    ("cuDNN/cuBLAS conv and GEMM", ("cudnn", "xmma", "conv", "gemm", "nvjet", "cutlass", "wgrad", "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise", "functor")),
    ("pooling", ("pool",)),
)
# the bench's ResNet-50 training FLOP per image (model_benches.py:41-45)
BENCH_FLOP_PER_IMAGE = 3.0 * 7.7e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def make_inputs(b, s, h, d, seed, with_mask, causal):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (
        torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        for _ in range(4)
    )
    mask = None
    if with_mask:
        mask = torch.ones((b, s), device="cuda")
        for row in range(b):
            mask[row, s - 37 * (row + 1):] = 0.0
        if not causal:
            # a batch row whose keys are all padding: uniform weights and
            # a finite lse in kernel and plain version alike
            mask[0] = 0.0
    return q, k, v, g, mask


def ptxas_summary(log: str) -> dict:
    """{"flash_fwd_kernel<64>": "0 bytes spilled; 80 registers", ...}
    from nvcc's -Xptxas -v output, with any C75xx warning (wgmmas
    serialized) under "warnings"."""
    import re

    summary, name = {}, None
    for line in log.splitlines():
        if re.search(r"C75\d\d", line):
            summary.setdefault("warnings", []).append(line.strip()[:200])
            continue
        entry = re.search(
            r"((?:flash_(?:fwd|bwd_dkv|bwd_dq)|conv3x3_(?:fwd|dw))_kernel)ILi(\d+)E", line
        )
        reduce = re.search(r"(conv3x3_dw_reduce_kernel)", line)
        if entry or reduce:
            name = f"{entry.group(1)}<{entry.group(2)}>" if entry else reduce.group(1)
            summary[name] = ""
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            summary[name] += f"{spill.group(1)} bytes spilled; "
        if name and regs:
            summary[name] += f"{regs.group(1)} registers"
    return summary


def model_flop_per_token(cfg, seq: int) -> int:
    """Training FLOP per token of BertForMLM: 3x the forward's matmuls
    (2 per weight for the projections, MLP and head; 4 * seq * hidden
    per layer for q.k and p.v), recomputation not counted."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    weights = cfg.num_layers * (4 * h * h + 2 * h * inter) + h * cfg.vocab_size
    return 3 * (2 * weights + 4 * cfg.num_layers * seq * h)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_case(kernels, fa, inputs, causal, case, worst) -> None:
    """K1-K3 against their plain versions on one set of inputs; records
    each kernel's (error, tolerance) in `case`, keeps the worst (error /
    tolerance) per kernel in `worst`, and raises on one out of
    tolerance."""
    q, k, v, g, mask = inputs
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, mask, causal, scale)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    delta = fa._delta(out_f32, g)
    args = (q, k, v, mask, g, lse, delta, causal, scale)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(*args)
    ref_dq = fa.flash_backward_dq_reference(*args)
    torch.cuda.synchronize()
    pairs = {
        "flash_fwd": [(out, ref_out)],
        "flash_bwd_dkv": [(dk, ref_dk), (dv, ref_dv)],
        "flash_bwd_dq": [(dq, ref_dq)],
    }
    for name, items in pairs.items():
        for got, want in items:
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {case}: bad shape or non-finite")
            err = max_err(got, want)
            tol = KERNEL_RTOL * max(1.0, want.float().abs().max().item())
            case[name] = [err, tol]
            if err > tol:
                raise AssertionError(f"{name} {case}: error {err} > {tol}")
            if name not in worst or err / tol > worst[name][0] / worst[name][1]:
                worst[name] = (err, tol)
    lse_err = (lse - ref_lse).abs().max().item()
    case["lse"] = lse_err
    if lse_err > 1e-3:
        raise AssertionError(f"lse {case}: error {lse_err}")
    # K1's f32 output (what delta is taken from) against the plain
    # version's before rounding (OUT_F32_P_RTOL, OUT_F32_RTOL)
    ref_f32, _ = fa._forward_f32(q, k, v, mask, causal, scale)
    f32_err = max_err(out_f32, ref_f32)
    f32_tol = (OUT_F32_P_RTOL * v.float().abs().max().item()
               + OUT_F32_RTOL * max(1.0, ref_f32.abs().max().item()))
    case["out_f32"] = [f32_err, f32_tol]
    if f32_err > f32_tol:
        raise AssertionError(f"out_f32 {case}: error {f32_err} > {f32_tol}")


def check_common_part(kernels, fa, shape, seed) -> dict:
    """The case behind delta's f32 O (tests/test_torch_flash_attention.py):
    q, k, dO from N(0, 1), v = 4 + 0.05 N(0, 1), all bf16. K1, then
    `_delta`, then K2 and K3, against the f32 plain gradients of the same
    bf16 values: relative L2 distance of dq, dk, dv each within
    COMMON_GRAD_RTOL."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, g = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    v = (4.0 + 0.05 * torch.randn((b, s, h, d), generator=gen, device="cuda")).bfloat16()
    scale = 1.0 / math.sqrt(d)
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, None, False, scale)
    args = (q, k, v, None, g, lse, fa._delta(out_f32, g), False, scale)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    ref_out, ref_lse = fa._forward_f32(qf, kf, vf, None, False, scale)
    ref = fa.flash_backward_reference(
        qf, kf, vf, None, gf, ref_lse, fa._delta(ref_out, gf), False, scale
    )
    torch.cuda.synchronize()
    case = {"shape": list(shape), "case": "common part (v = 4 + 0.05 noise)",
            "grad_rtol": COMMON_GRAD_RTOL}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        case[name] = ((got.float() - want).norm() / want.norm()).item()
    emit({"phase": "kernel_check", **case})
    worst = max(case["dq"], case["dk"], case["dv"])
    if not math.isfinite(worst) or worst > COMMON_GRAD_RTOL:
        raise AssertionError(f"common-part gradients {case}")
    return case


def check_kernels(kernels, fa) -> dict:
    """Each kernel against its plain version at CHECK_SHAPES, with and
    without the mask, causal and not; returns per kernel the worst
    (error / tolerance) case as (error, tolerance)."""
    worst = {}
    for b, s, h, d in CHECK_SHAPES:
        for causal in (False, True):
            for with_mask in (False, True):
                inputs = make_inputs(b, s, h, d, 1, with_mask, causal)
                case = {"shape": [b, s, h, d], "causal": causal, "mask": with_mask}
                check_case(kernels, fa, inputs, causal, case, worst)
                emit({"phase": "kernel_check", **case})
        check_common_part(kernels, fa, (b, s, h, d), 3)
    return worst


def time_kernels(kernels, fa, worst) -> dict:
    """At the main-path shape: each kernel against its plain version
    (into `worst`), then the median ms of each kernel, its plain version
    and the library call, plus the bound from these inputs."""
    b, s, h, d = MAIN_SHAPE
    inputs = make_inputs(b, s, h, d, 2, False, False)
    case = {"shape": list(MAIN_SHAPE), "causal": False, "mask": False}
    check_case(kernels, fa, inputs, False, case, worst)
    emit({"phase": "kernel_check", **case})
    q, k, v, g, _ = inputs
    scale = 1.0 / math.sqrt(d)
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, None, False, scale)
    delta = fa._delta(out_f32, g)
    args = (q, k, v, None, g, lse, delta, False, scale)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)

    def sdpa_backward():
        torch.autograd.grad(sdpa_out, (qt, kt, vt), gt, retain_graph=True)

    with torch.no_grad():
        sdpa_fwd_ms = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    sdpa_bwd_ms = median_ms(sdpa_backward)

    n = b * s * h * d  # elements of one [b, s, h, d] tensor
    pairs = b * h * s * s
    stats_bytes = 4 * b * h * s  # one f32 row statistic
    work = {
        # name: (FLOP, bytes: each input read once, each output written
        # once). K1's outputs are O in bf16 and lse, as the TPU kernel's;
        # its extra f32 copy of O is reported beside the bound.
        "flash_fwd": (4 * pairs * d, 2 * 3 * n + 2 * n + stats_bytes),
        "flash_bwd_dkv": (8 * pairs * d, 2 * 4 * n + 2 * stats_bytes + 2 * 2 * n),
        "flash_bwd_dq": (6 * pairs * d, 2 * 4 * n + 2 * stats_bytes + 2 * n),
    }
    timed = {
        "flash_fwd": (
            lambda: kernels.flash_fwd(q, k, v, None, False, scale),
            lambda: fa.flash_forward_reference(q, k, v, None, False, scale),
            sdpa_fwd_ms,
        ),
        "flash_bwd_dkv": (
            lambda: kernels.flash_bwd_dkv(*args),
            lambda: fa.flash_backward_dkv_reference(*args),
            sdpa_bwd_ms,
        ),
        "flash_bwd_dq": (
            lambda: kernels.flash_bwd_dq(*args),
            lambda: fa.flash_backward_dq_reference(*args),
            sdpa_bwd_ms,
        ),
    }
    result = {}
    for name, (kernel_fn, plain_fn, library_ms) in timed.items():
        flops, nbytes = work[name]
        op_ms = flops / PEAK_BF16_FLOPS * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        result[name] = {
            "ms": median_ms(kernel_fn),
            "plain_ms": median_ms(plain_fn, iters=5, warmup=1),
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms,
            "flop": flops,
            "bytes": nbytes,
        }
        result[name]["tflops"] = flops / result[name]["ms"] / 1e9
    f32_out_bytes = 4 * n
    emit({"phase": "kernel_times", "shape": list(MAIN_SHAPE), "dtype": "bfloat16",
          "flash_fwd_f32_out_bytes": f32_out_bytes,
          "flash_fwd_f32_out_ms_at_peak": f32_out_bytes / PEAK_BYTES * 1e3,
          "library": "F.scaled_dot_product_attention (K2, K3: its backward, "
                     "dq+dk+dv together)", **result})
    return result


def profile_step(bert_lib, trainer_lib, flash_attention) -> None:
    """Device time of two BERT-base flash training steps by kernel
    (torch.profiler), the flash kernels' share of it, and the device's
    busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = bert_lib.BERT_BASE
    model = bert_lib.BertForMLM(
        cfg, attention_fn=flash_attention, generator=torch.Generator().manual_seed(5)
    )
    trainer = trainer_lib.Trainer(
        model, trainer_lib.mlm_task(model), learning_rate=1e-4,
        weight_decay=0.01, packed=True, device="cuda",
    )
    state = trainer.init()
    batch = trainer.place_batch(bert_lib.synthetic_batch(
        torch.Generator().manual_seed(6), MAIN_SHAPE[0], MAIN_SHAPE[1], cfg
    ))
    state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) * 1e3
    kernels = device_kernels(prof)
    total_us = sum(e.self_device_time_total for e in kernels)
    ours = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    flash_us = sum(
        e.self_device_time_total for e in kernels if any(n in e.key for n in ours)
    )
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({
        "phase": "profile", "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_us / 1e3 / steps,
        "device_busy_share": total_us / 1e3 / wall_ms if wall_ms else None,
        "flash_kernels_ms_per_step": flash_us / 1e3 / steps,
        "flash_share_of_device": flash_us / total_us if total_us else None,
        "top": [
            {"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    })


def device_kernels(prof) -> list:
    """The profile's device events, without the user annotations that
    the profiler also lists on the device (`Optimizer.step#AdamW.step`,
    `ProfilerStep#n`): those span kernels that are listed themselves,
    and counting them would count that time twice."""
    return [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.key.startswith(("Optimizer.", "ProfilerStep#"))
    ]


def padded_batch(bert_lib, cfg, batch_size, seq_len, seed):
    gen = torch.Generator().manual_seed(seed)
    batch = bert_lib.synthetic_batch(gen, batch_size, seq_len, cfg)
    for row in range(batch_size):
        length = seq_len - 13 * row
        batch["attention_mask"][row, length:] = 0
        batch["mlm_weights"][row, length:] = 0.0
    return batch


def plain_parity(kernels, bert_lib, trainer_lib, flash_attention) -> dict:
    """One step from the same weights and batch through the flash
    kernels and through the plain attention path, both in bf16, packed
    and unpacked; the unpacked flash step must launch each kernel once
    per layer. Gradients are held against the same step in f32 (plain
    attention, full-f32 matmuls): the flash route may be no further
    from it than the plain bf16 route, parameter by parameter."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = bert_lib.BERT_BASE
    routes = (
        ("flash", flash_attention, base),
        ("plain", None, base),
        ("f32", None, dataclasses.replace(base, dtype=torch.float32)),
    )
    batch_size, seq_len = MAIN_SHAPE[0], MAIN_SHAPE[1]
    report = {}
    for packed in (True, False):
        if packed:
            batch = bert_lib.synthetic_batch(
                torch.Generator().manual_seed(7), batch_size, seq_len, base
            )
        else:
            batch = padded_batch(bert_lib, base, batch_size, seq_len, seed=7)
        losses, grads = {}, {}
        for route, attention_fn, cfg in routes:
            model = bert_lib.BertForMLM(
                cfg, attention_fn=attention_fn,
                generator=torch.Generator().manual_seed(3),
            )
            trainer = trainer_lib.Trainer(
                model, trainer_lib.mlm_task(model), learning_rate=1e-4,
                weight_decay=0.01, packed=packed, device="cuda",
            )
            state = trainer.init()
            kernels.reset_launches()
            state, metrics = trainer.step(state, trainer.place_batch(batch))
            losses[route] = float(metrics["loss"])
            counts = dict(kernels.LAUNCHES)
            want = LAYERS if route == "flash" else 0
            if any(counts[k] != want for k in FLASH_KERNELS) or any(
                counts[k] for k in CONV_KERNELS
            ):
                raise AssertionError(
                    f"{route} packed={packed}: launches {counts}, want {want} per "
                    "flash kernel and no conv launch"
                )
            grads[route] = {n: p.grad for n, p in model.named_parameters()}
            del model, trainer, state
        errors = {"flash": {}, "plain": {}}
        for name, truth in grads["f32"].items():
            if name.endswith("attention.key.bias"):
                # zero in exact arithmetic (a key bias shifts every score
                # of a row by q.b, which the softmax ignores), so every
                # route holds only rounding noise there
                continue
            for route in errors:
                diff = (grads[route][name] - truth).norm() / truth.norm().clamp_min(1e-30)
                errors[route][name] = diff.item()
        worst = {r: max(e.items(), key=lambda kv: kv[1]) for r, e in errors.items()}
        ratios = sorted(
            ((errors["flash"][n] / max(errors["plain"][n], GRAD_FLOOR), n,
              errors["flash"][n], errors["plain"][n]) for n in errors["flash"]),
            reverse=True,
        )
        ratio, ratio_name = ratios[0][0], ratios[0][1]
        key = "packed" if packed else "unpacked"
        report[key] = {
            "loss_flash": losses["flash"], "loss_plain": losses["plain"],
            "loss_f32": losses["f32"],
            "loss_diff": abs(losses["flash"] - losses["plain"]), "loss_atol": LOSS_ATOL,
            "worst_grad_err_flash": worst["flash"], "worst_grad_err_plain": worst["plain"],
            "worst_flash_over_plain": [ratio_name, ratio, GRAD_RATIO],
            "top_ratios": ratios[:6],
        }
        emit({"phase": "plain_parity", "batch": key, **report[key]})
        if not all(math.isfinite(x) for x in losses.values()):
            raise AssertionError(f"non-finite loss {losses}")
        if report[key]["loss_diff"] > LOSS_ATOL:
            raise AssertionError(f"{key}: loss diff {report[key]['loss_diff']} > {LOSS_ATOL}")
        if ratio > GRAD_RATIO:
            raise AssertionError(
                f"{key}: gradient of {ratio_name} is {ratio}x further from f32 "
                f"than the plain path's (> {GRAD_RATIO})"
            )
        del grads
        torch.cuda.empty_cache()
    return report


def conv_inputs(shape, cout, seed):
    """bf16 x [N, H, W, C], kernel [3, 3, C, Cout] (scaled to keep y near
    unit size), cotangent g [N, H, W, Cout] and the dx kernel (flipped on
    (0, 1), transposed on (2, 3)), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / math.sqrt(9 * c)).bfloat16()
    g = torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
    return x, k, g, k.flip(0, 1).transpose(2, 3).contiguous()


def check_conv_case(kernels, conv_bn, shape, cout, seed, worst) -> dict:
    """K4 forward, K4 as dx and K5 against their plain versions on one
    set of inputs, and K5 against itself on a rerun (bit-equal); keeps
    the worst (error / tolerance) per kernel in `worst` and raises on
    one out of tolerance."""
    x, k, g, k_flip = conv_inputs(shape, cout, seed)
    pairs = {
        "fwd": ("conv3x3_fwd", kernels.conv3x3_fwd(x, k), conv_bn.conv3x3_fwd_plain(x, k), KERNEL_RTOL),
        "dx": ("conv3x3_fwd", kernels.conv3x3_fwd(g, k_flip),
               conv_bn.conv3x3_fwd_plain(g, k_flip), KERNEL_RTOL),
        "dw": ("conv3x3_dw", kernels.conv3x3_dw(x, g), conv_bn.conv3x3_dw_plain(x, g), DW_RTOL),
    }
    # K5 sums its split-K partials in a fixed order: bit-equal on a rerun
    again = kernels.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    case = {"shape": list(shape), "cout": cout,
            "fwd_plan": kernels.fwd_plan(*shape, cout)._asdict()}
    if not torch.equal(again, pairs["dw"][1]):
        raise AssertionError(f"conv3x3_dw {case}: two runs on the same inputs differ")
    for part, (name, got, want, rtol) in pairs.items():
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"{name} ({part}) {case}: bad shape, dtype or non-finite")
        err = max_err(got, want)
        tol = rtol * max(1.0, want.float().abs().max().item())
        case[part] = [err, tol]
        if err > tol:
            raise AssertionError(f"{name} ({part}) {case}: error {err} > {tol}")
        if name not in worst or err / tol > worst[name][0] / worst[name][1]:
            worst[name] = (err, tol)
    return case


def check_conv_kernels(kernels, conv_bn) -> dict:
    """K4/K5 against their plain versions at the stage shapes (N=8) and
    the C != Cout cases; returns per kernel the worst case as (error,
    tolerance)."""
    worst = {}
    cases = [((CONV_CHECK_N, size, size, c), c) for size, c, _ in CONV_STAGES]
    for i, (shape, cout) in enumerate(cases + list(CONV_EXTRA_CASES)):
        emit({"phase": "conv_check", **check_conv_case(kernels, conv_bn, shape, cout, 10 + i, worst)})
    return worst


def conv_work(m: int, c: int, cout: int) -> dict:
    """(FLOP, bytes) of each function at one shape: each input read once
    and each output written once."""
    flop = 2 * m * 9 * c * cout
    return {
        "fwd": (flop, 2 * m * c + 2 * 9 * c * cout + 2 * m * cout),
        "dx": (flop, 2 * m * cout + 2 * 9 * c * cout + 2 * m * c),
        "dw": (flop, 2 * m * c + 2 * m * cout + 4 * 9 * c * cout),
    }


def k4_l2_request_bytes(kernels, shape, cout: int) -> int:
    """Bytes K4's TMA loads request at one shape, modelled from its plan
    (no counter measures them): each block requests, for each of its
    9 * C/64 steps, one x box (FWD_PIXELS rows of 128 bytes) and BN/64
    weight slabs of 64 rows of 128 bytes, served from L2 or HBM."""
    n, h, w, c = shape
    plan = kernels.fwd_plan(n, h, w, c, cout)
    step = (kernels.FWD_PIXELS + plan.bn) * 128
    return plan.boxes * (cout // plan.bn) * 9 * (c // 64) * step


def time_conv_kernels(kernels, conv_bn, worst) -> dict:
    """At each stage shape at N=256: the kernels against their plain
    versions once more (into `worst`), then the median ms of each kernel,
    its plain version and the cuDNN call on the same inputs, with the
    bound from these inputs. Returns the per-stage numbers and the
    per-step totals, weighted by each stage's launches."""
    grad = torch.nn.grad
    stages = []
    for i, (size, c, count) in enumerate(CONV_STAGES):
        shape = (RESNET_BATCH, size, size, c)
        case = check_conv_case(kernels, conv_bn, shape, c, 20 + i, worst)
        emit({"phase": "conv_check", **case})
        x, k, g, k_flip = conv_inputs(shape, c, 20 + i)
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels_last views
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        w_flip_oihw = k_flip.permute(3, 2, 0, 1).contiguous()
        timed = {
            "fwd": (lambda: kernels.conv3x3_fwd(x, k),
                    lambda: conv_bn.conv3x3_fwd_plain(x, k),
                    lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            "dx": (lambda: kernels.conv3x3_fwd(g, k_flip),
                   lambda: conv_bn.conv3x3_fwd_plain(g, k_flip),
                   lambda: F.conv2d(g_nchw, w_flip_oihw, padding=1)),
            "dw": (lambda: kernels.conv3x3_dw(x, g),
                   lambda: conv_bn.conv3x3_dw_plain(x, g),
                   lambda: grad.conv2d_weight(x_nchw, w_oihw.shape, g_nchw, padding=1)),
        }
        work = conv_work(RESNET_BATCH * size * size, c, c)
        entry = {"shape": list(shape), "cout": c, "launches_per_pass": count,
                 "fwd_plan": kernels.fwd_plan(*shape, c)._asdict()}
        for part, (kernel_fn, plain_fn, library_fn) in timed.items():
            flops, nbytes = work[part]
            op_ms = flops / PEAK_BF16_FLOPS * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            entry[part] = {
                "ms": median_ms(kernel_fn),
                "plain_ms": median_ms(plain_fn, iters=5, warmup=1),
                "library_ms": median_ms(library_fn),
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "flop": flops, "bytes": nbytes,
            }
            entry[part]["tflops"] = flops / entry[part]["ms"] / 1e9
        # cuDNN's dgrad on the same inputs, beside the forward call on k_flip
        entry["dx"]["dgrad_ms"] = median_ms(
            lambda: grad.conv2d_input(x_nchw.shape, w_oihw, g_nchw, padding=1))
        # the L2 request rate K4's plan implies: modelled bytes over measured time
        entry["fwd"]["l2_request_bytes_modelled"] = k4_l2_request_bytes(kernels, shape, c)
        entry["fwd"]["l2_request_tb_per_s_modelled"] = (
            entry["fwd"]["l2_request_bytes_modelled"] / entry["fwd"]["ms"] / 1e9)
        emit({"phase": "conv_times", "dtype": "bfloat16",
              "library": "cuDNN via F.conv2d (fwd; dx on the flipped, transposed kernel) / "
                         "torch.nn.grad.conv2d_weight, bf16 channels_last", **entry})
        del x, k, g, k_flip, x_nchw, g_nchw, w_oihw, w_flip_oihw, timed
        torch.cuda.empty_cache()
        stages.append(entry)
    # per training step: K4 runs the forward and dx of each conv, K5 its dW
    parts = {"conv3x3_fwd": ("fwd", "dx"), "conv3x3_dw": ("dw",)}
    totals = {}
    for name, names in parts.items():
        totals[name] = {
            key: sum(st["launches_per_pass"] * st[part][key] for st in stages for part in names)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")
        }
        op = sum(st["launches_per_pass"] * st[part]["flop"] for st in stages for part in names)
        by = sum(st["launches_per_pass"] * st[part]["bytes"] for st in stages for part in names)
        totals[name]["bound_by"] = (
            "operations" if op / PEAK_BF16_FLOPS >= by / PEAK_BYTES else "bytes"
        )
    emit({"phase": "conv_times_per_step", "basis": "13 stride-1 3x3 convs per pass: "
          "K4 forward + dx, K5 dW, weighted 3/3/5/2 by stage", **totals})
    return {"stages": stages, "totals": totals}


def resnet_flop_per_image(resnet_lib) -> int:
    """Training FLOP per 224x224 image of ResNet-50, counted from its
    layer shapes: 2 per multiply-add of every conv and the Dense in the
    forward, times 3 for forward and backward (recomputation none)."""
    model = resnet_lib.ResNet50(conv3_impl="xla").cuda()
    macs = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Linear):
            macs.append(module.in_features * module.out_features)
        else:  # an OIHW conv: I * kh * kw multiply-adds per output value
            macs.append(output[0].numel() * module.weight[0].numel())

    handles = [
        m.register_forward_hook(hook) for m in model.modules()
        if isinstance(m, (resnet_lib.Conv, torch.nn.Linear))
    ]
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, RESNET_IMAGE, RESNET_IMAGE, 3), device="cuda"))
    for handle in handles:
        handle.remove()
    return 3 * 2 * sum(macs)


def resnet_args(resnet_cli, conv3_impl: str):
    return resnet_cli.parse_args([
        "--steps", "5", "--per-chip-batch", str(RESNET_BATCH),
        "--image-size", str(RESNET_IMAGE), "--learning-rate", "0.1",
        "--conv3-impl", conv3_impl, "--log-every", "1",
    ])


def profile_resnet(resnet_lib, trainer_lib, conv3_impl: str) -> None:
    """Device time of two ResNet-50 training steps by kernel and by kind
    of kernel (torch.profiler), K4/K5's share of it, and the device's
    busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    model = resnet_lib.ResNet50(conv3_impl=conv3_impl, generator=torch.Generator().manual_seed(5))
    trainer = trainer_lib.Trainer(
        model, trainer_lib.classification_task(model), learning_rate=0.1,
        device="cuda", optimizer="sgd",
    )
    state = trainer.init()
    batch = trainer.place_batch(resnet_lib.synthetic_batch(
        torch.Generator().manual_seed(6), RESNET_BATCH, RESNET_IMAGE
    ))
    state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) * 1e3
    kernels = device_kernels(prof)
    total_us = sum(e.self_device_time_total for e in kernels)
    ours = ("conv3x3_fwd_kernel", "conv3x3_dw_kernel", "conv3x3_dw_reduce_kernel")
    by_ours = {
        n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3 / steps
        for n in ours
    }
    conv_us = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in ours))
    by_category, members = {}, {}
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        category = next(
            (name for name, keys in PROFILE_CATEGORIES if any(k in e.key.lower() for k in keys)),
            "other",
        )
        by_category[category] = by_category.get(category, 0.0) + e.self_device_time_total / 1e3 / steps
        members.setdefault(category, [])
        if len(members[category]) < 3:  # the largest few, to check the sorting
            members[category].append(e.key[:70])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({
        "phase": "resnet_profile", "conv3_impl": conv3_impl, "steps": steps,
        "batch": RESNET_BATCH,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_us / 1e3 / steps,
        "device_busy_share": total_us / 1e3 / wall_ms if wall_ms else None,
        "conv3x3_kernels_ms_per_step": conv_us / 1e3 / steps,
        "conv3x3_kernels_by_name_ms_per_step": by_ours,
        "conv3x3_share_of_device": conv_us / total_us if total_us else None,
        "ms_per_step_by_category": by_category,
        "largest_by_category": members,
        "top": [
            {"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    })


def resnet_parity(kernels, resnet_lib, trainer_lib) -> dict:
    """One SGD step from the same weights and batch (N=32, 224x224)
    through K4/K5 ("pallas"), the torch conv in bf16 ("xla") and the
    torch conv in f32 with TF32 off ("f32"). The BatchNorm scales are
    drawn around 1 first: at init the last BN of each block has scale 0,
    which zeroes every gradient inside the residual branches, K4's dx
    and K5's dW included. Checks: the pallas step launches 13 K4 per pass
    and 13 K5; losses within LOSS_ATOL; each parameter's gradient and
    each BN running statistic no more than GRAD_RATIO times further
    (relative L2, floor GRAD_FLOOR) from the f32 step than the xla bf16
    step's; one evaluate in eval mode, finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    base = resnet_lib.ResNet50(conv3_impl="xla", generator=gen)
    with torch.no_grad():
        for module in base.modules():
            if isinstance(module, resnet_lib.TpuBatchNorm):
                module.scale.uniform_(0.5, 1.5, generator=gen)
    xla_state = base.state_dict()

    def to_pallas(state):
        # the Conv_1 weights OIHW -> PallasConv3x3's HWIO kernel
        out = {}
        for name, value in state.items():
            if name.endswith("Conv_1.weight"):
                out[name[: -len("weight")] + "kernel"] = value.permute(2, 3, 1, 0).contiguous()
            else:
                out[name] = value
        return out

    batch = resnet_lib.synthetic_batch(
        torch.Generator().manual_seed(9), RESNET_PARITY_BATCH, RESNET_IMAGE
    )
    routes = (
        ("pallas", dict(conv3_impl="pallas"), to_pallas(xla_state)),
        ("xla", dict(conv3_impl="xla"), xla_state),
        ("f32", dict(conv3_impl="xla", dtype=torch.float32), xla_state),
    )
    losses, grads, stats = {}, {}, {}
    pallas_eval = None
    for route, kwargs, state_dict in routes:
        model = resnet_lib.ResNet50(**kwargs)
        model.load_state_dict(state_dict)
        trainer = trainer_lib.Trainer(
            model, trainer_lib.classification_task(model), learning_rate=0.1,
            device="cuda", optimizer="sgd",
        )
        state = trainer.init()
        placed = trainer.place_batch(batch)
        kernels.reset_launches()
        state, metrics = trainer.step(state, placed)
        losses[route] = float(metrics["loss"])
        counts = dict(kernels.LAUNCHES)
        want = {k: 0 for k in counts}
        if route == "pallas":
            want.update(conv3x3_fwd=2 * CONVS_PER_PASS, conv3x3_dw=CONVS_PER_PASS)
        if counts != want:
            raise AssertionError(f"resnet_parity {route}: launches {counts} != {want}")
        grads[route] = {}
        for name, param in model.named_parameters():
            g = param.grad
            if name.endswith("Conv_1.kernel"):
                name, g = name[: -len("kernel")] + "weight", g.permute(3, 2, 0, 1)
            grads[route][name] = g
        stats[route] = {n: b.clone() for n, b in model.named_buffers()}
        if route == "pallas":
            pallas_eval = {k: float(v) for k, v in trainer.evaluate(state, placed).items()}
        del model, trainer, state
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    report = {"losses": losses, "loss_diff": abs(losses["pallas"] - losses["xla"]),
              "loss_atol": LOSS_ATOL, "eval_pallas": pallas_eval}
    for kind, table in (("grad", grads), ("stat", stats)):
        ratios = sorted(
            ((rel(table["pallas"][n], table["f32"][n]) / max(rel(table["xla"][n], table["f32"][n]), GRAD_FLOOR),
              n, rel(table["pallas"][n], table["f32"][n]), rel(table["xla"][n], table["f32"][n]))
             for n in table["f32"]),
            reverse=True,
        )
        report[f"worst_{kind}_pallas_over_xla"] = [ratios[0][1], ratios[0][0], GRAD_RATIO]
        report[f"worst_{kind}_err_pallas"] = max(r[2] for r in ratios)
        report[f"worst_{kind}_err_xla"] = max(r[3] for r in ratios)
        report[f"top_{kind}_ratios"] = ratios[:5]
    emit({"phase": "resnet_parity", "batch": RESNET_PARITY_BATCH, **report})
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"non-finite loss {losses}")
    if report["loss_diff"] > LOSS_ATOL:
        raise AssertionError(f"resnet loss diff {report['loss_diff']} > {LOSS_ATOL}")
    for kind in ("grad", "stat"):
        name, ratio, _ = report[f"worst_{kind}_pallas_over_xla"]
        if ratio > GRAD_RATIO:
            raise AssertionError(
                f"{kind} of {name} is {ratio}x further from f32 than the xla path's"
            )
    if not all(math.isfinite(v) for v in pallas_eval.values()):
        raise AssertionError(f"non-finite evaluate {pallas_eval}")
    return report


def run_resnet(kernels, resnet_lib, resnet_cli, smi) -> dict:
    """resnet_train (pallas, launch counts checked) and resnet_train_xla."""
    flop_per_image = resnet_flop_per_image(resnet_lib)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    summary = resnet_cli.run(resnet_args(resnet_cli, "pallas"))
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want["conv3x3_fwd"] = CONVS_PER_PASS * (summary["forward_passes"] + summary["backward_passes"])
    want["conv3x3_dw"] = CONVS_PER_PASS * summary["backward_passes"]
    emit({"phase": "resnet_train", "model": "ResNet-50", "conv3_impl": "pallas",
          "batch": RESNET_BATCH, "image": RESNET_IMAGE, "card": smi, **summary,
          "model_flop_per_image": flop_per_image,
          "bench_flop_per_image": BENCH_FLOP_PER_IMAGE,
          "mfu": summary["images_per_sec"] * flop_per_image / PEAK_BF16_FLOPS,
          "mfu_bench_flop": summary["images_per_sec"] * BENCH_FLOP_PER_IMAGE / PEAK_BF16_FLOPS,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_expected": want})
    if launches != want:
        raise AssertionError(f"resnet launches {launches} != expected {want}")
    for key in ("loss", "images_per_sec"):
        if not math.isfinite(summary[key]) or summary[key] <= 0:
            raise AssertionError(f"resnet_train {key} = {summary[key]}")
    torch.cuda.empty_cache()
    kernels_before = dict(kernels.LAUNCHES)
    xla = resnet_cli.run(resnet_args(resnet_cli, "xla"))
    if kernels.LAUNCHES != kernels_before:
        raise AssertionError("the xla route launched a conv kernel")
    emit({"phase": "resnet_train_xla", "conv3_impl": "xla", "card": smi, **xla,
          "mfu": xla["images_per_sec"] * flop_per_image / PEAK_BF16_FLOPS})
    if not math.isfinite(xla["loss"]):
        raise AssertionError(f"resnet_train_xla loss {xla['loss']}")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card")
    from tf_operator_tpu_torch.models import bert as bert_lib
    from tf_operator_tpu_torch.models import resnet as resnet_lib
    from tf_operator_tpu_torch.ops import conv_bn
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import kernels
    from tf_operator_tpu_torch.train import bert as bert_cli
    from tf_operator_tpu_torch.train import resnet as resnet_cli
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    start = time.monotonic()
    kernels.library()
    build_s = time.monotonic() - start
    ptxas = ptxas_summary(str(kernels.build_info.get("ptxas", "")))
    emit({"phase": "build", "seconds": build_s, "nvcc_seconds": kernels.build_info["seconds"],
          "compile_seconds": kernels.build_info.get("compile_seconds"),
          "sources": kernels.build_info.get("sources"),
          "library": kernels.build_info["path"], "ptxas": ptxas})

    worst = check_kernels(kernels, fa)
    times = time_kernels(kernels, fa, worst)

    args = bert_cli.parse_args([
        "--preset", "base", "--steps", "5", "--batch-size", str(MAIN_SHAPE[0]),
        "--seq-len", str(MAIN_SHAPE[1]), "--flash", "--packed",
        "--weight-decay", "0.01", "--learning-rate", "1e-4", "--log-every", "1",
    ])
    kernels.reset_launches()
    summary = bert_cli.run(args)
    launches = dict(kernels.LAUNCHES)
    want = {
        "flash_fwd": LAYERS * summary["forward_passes"],
        "flash_bwd_dkv": LAYERS * summary["backward_passes"],
        "flash_bwd_dq": LAYERS * summary["backward_passes"],
        "conv3x3_fwd": 0, "conv3x3_dw": 0,
    }
    flop_per_token = model_flop_per_token(bert_lib.BERT_BASE, MAIN_SHAPE[1])
    emit({"phase": "train", "model": "BERT-base MLM", "batch": MAIN_SHAPE[0],
          "seq": MAIN_SHAPE[1], "card": smi, **summary,
          "model_flop_per_token": flop_per_token,
          "mfu": summary["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS,
          "launches": launches, "launches_expected": want})
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    for key in ("loss", "eval_loss", "tokens_per_sec"):
        if not math.isfinite(summary[key]) or summary[key] <= 0:
            raise AssertionError(f"train {key} = {summary[key]}")
    torch.cuda.empty_cache()

    # the same run through the plain attention path, for comparison
    plain = bert_cli.run(bert_cli.parse_args([
        "--preset", "base", "--steps", "5", "--batch-size", str(MAIN_SHAPE[0]),
        "--seq-len", str(MAIN_SHAPE[1]), "--packed", "--weight-decay", "0.01",
        "--learning-rate", "1e-4", "--log-every", "1",
    ]))
    emit({"phase": "train_plain", "card": smi, **plain,
          "mfu": plain["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS})
    torch.cuda.empty_cache()

    profile_step(bert_lib, trainer_lib, fa.flash_attention)
    torch.cuda.empty_cache()

    plain_parity(kernels, bert_lib, trainer_lib, fa.flash_attention)
    torch.cuda.empty_cache()

    conv_worst = check_conv_kernels(kernels, conv_bn)
    conv_times = time_conv_kernels(kernels, conv_bn, conv_worst)
    resnet_launches = run_resnet(kernels, resnet_lib, resnet_cli, smi)
    for conv3_impl in ("pallas", "xla"):
        profile_resnet(resnet_lib, trainer_lib, conv3_impl)
        torch.cuda.empty_cache()
    resnet_parity(kernels, resnet_lib, trainer_lib)

    lines = [
        {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name][0], "tolerance": worst[name][1],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"],
            "basis": "per launch at one BERT-base layer; launches over the train phase",
        }
        for name in FLASH_KERNELS
    ]
    parts = {"conv3x3_fwd": ("fwd", "dx"), "conv3x3_dw": ("dw",)}
    for name in CONV_KERNELS:
        total = conv_times["totals"][name]
        lines.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE,
            "replaces": REPLACES[name], "launches": resnet_launches[name],
            "max_abs_err": conv_worst[name][0], "tolerance": conv_worst[name][1],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
            "library_ms": total["library_ms"],
            "basis": "per ResNet-50 training step at batch 256 (stage launches "
                     "3/3/5/2 per pass); launches over the resnet_train phase",
            "per_stage": [
                {"shape": st["shape"], **{
                    part: {k: st[part][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")}
                    for part in parts[name]
                }}
                for st in conv_times["stages"]
            ],
        })
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
