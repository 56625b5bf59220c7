"""The port's flash attention (tf_operator_tpu_torch/ops/flash_attention.py)
held against the JAX package's, on the same numpy inputs.

On the CPU the port's wrapper runs the kernels' plain f32 versions and
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_attention.py runs them. The tolerances are the reference's
own (tests/test_attention.py): f32 forward atol 2e-6, gradients 1e-4
(2e-4 where several key blocks stream, as there). The test of the CUDA
kernels against their plain versions needs a card and skips without
one; on a machine with a card and no JAX run it with
`python -m pytest --noconftest tests/test_torch_flash_attention.py -m cuda`.
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.attention import dot_product_attention as jax_dpa
    from tf_operator_tpu.ops.pallas.flash_attention import (
        flash_attention as jax_flash,
    )
except ImportError:  # a card machine without JAX runs only the cuda test
    jax = None

from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import kernels
from tf_operator_tpu_torch.ops.attention import dot_product_attention

FWD_ATOL = 2e-6
GRAD_ATOL = 1e-4
# seq 640 streams five 128-key blocks in the JAX kernel (as the
# reference's multi-block streaming test, which allows 2e-4)
GRAD_ATOL_MULTI_BLOCK = 2e-4


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (
        rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)
    )
    return q, k, v, w


def _jax_out_and_grads(fn, q, k, v, w):
    # one vjp: a single trace gives the output and the gradients of
    # sum(out * w)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(w))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_out_and_grads(fn, q, k, v, w):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _compare(got, want, grad_atol):
    out, grads = got
    ref_out, ref_grads = want
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=grad_atol, err_msg=f"d{name}")


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("seq", [128, 256, 640])
@pytest.mark.parametrize("kind", ["none", "padding", "causal"])
def test_flash_matches_jax(head_dim, seq, kind):
    """Forward and dq/dk/dv. The padding case holds one batch row whose
    keys are all padding (uniform weights, finite lse in both) and one
    with a ragged length; as in BERT, padded query rows carry no loss
    weight."""
    b, h = 2, 2
    q, k, v, w = _inputs(b, seq, h, head_dim, seed=seq + head_dim)
    mask = None
    causal = kind == "causal"
    if kind == "padding":
        lengths = np.array([0, seq - 37])
        valid = np.arange(seq)[None, :] < lengths[:, None]  # [b, s]
        mask = valid[:, None, None, :]
        w = w * valid[:, :, None, None]
    got = _torch_out_and_grads(
        lambda q, k, v: fa.flash_attention(
            q, k, v, None if mask is None else torch.tensor(mask), causal=causal
        ),
        q, k, v, w,
    )
    want = _jax_out_and_grads(
        lambda q, k, v: jax_flash(
            q, k, v, None if mask is None else jnp.asarray(mask), causal=causal
        ),
        q, k, v, w,
    )
    _compare(got, want, GRAD_ATOL_MULTI_BLOCK if seq == 640 else GRAD_ATOL)


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("causal", [False, True])
def test_other_masks_take_the_plain_route(causal):
    """A query-dependent [b, 1, sq, sk] mask is not the kernel's form:
    both packages fall back to dot_product_attention, keeping
    causality."""
    b, s, h, d = 2, 128, 2, 64
    q, k, v, w = _inputs(b, s, h, d, seed=11)
    rng = np.random.default_rng(12)
    mask = rng.random((b, 1, s, s)) > 0.3
    mask[..., 0] = True  # every query row keeps one key
    before = dict(kernels.LAUNCHES)
    got = _torch_out_and_grads(
        lambda q, k, v: fa.flash_attention(q, k, v, torch.tensor(mask), causal=causal),
        q, k, v, w,
    )
    want = _jax_out_and_grads(
        lambda q, k, v: jax_flash(q, k, v, jnp.asarray(mask), causal=causal),
        q, k, v, w,
    )
    _compare(got, want, GRAD_ATOL)
    assert kernels.LAUNCHES == before


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_attention_matches_jax(dtype):
    """The plain attention keeps the reference's casts: scale on q in
    the input dtype, f32 softmax with finfo.min masking, weights cast
    back. bf16 agrees to a bf16 rounding of the output (2^-8 relative)."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v, _ = _inputs(b, s, h, d, seed=5)
    mask = np.tril(np.ones((s, s), bool))[None, None]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(
        jax_dpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(mask)),
        np.float32,
    )
    got = dot_product_attention(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), torch.tensor(mask)
    ).float().numpy()
    atol = FWD_ATOL if dtype == "float32" else 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol)


def test_supports():
    """The kernels are built for head_dim 64 and 128 only, at any
    sequence length."""
    for d in (64, 128):
        assert fa.supports(640, 640, d)
        assert fa.supports(1, 77, d)
    for d in (32, 96, 256):
        assert not fa.supports(128, 128, d)
    assert not fa.supports(0, 128, 64)


@pytest.mark.parametrize("head_dim", [32, 96])
def test_unsupported_head_dim_takes_the_plain_route(head_dim):
    b, s, h = 1, 16, 2
    q, k, v, _ = _inputs(b, s, h, head_dim, seed=3)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool))[None, None]
    want = dot_product_attention(tq, tk, tv, causal)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def test_bf16_gradients_take_delta_from_the_f32_output(monkeypatch):
    """Values with a large common part make O large against v_k - O.
    With delta = rowsum(dO * O) taken from K1's f32 output, bf16 dq, dk
    and dv stay within 1% of the same gradients computed in f32; taking
    it from O rounded to bf16, as the reference does, moves dq and dk
    more than 5% away (and leaves dv alone)."""
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 128, 2, 64
    q, k, g = (rng.standard_normal((b, s, h, d)) for _ in range(3))
    v = 4.0 + 0.05 * rng.standard_normal((b, s, h, d))
    bf16 = [torch.tensor(x, dtype=torch.float32).bfloat16() for x in (q, k, v, g)]

    def grads(dtype):
        tq, tk, tv = (x.to(dtype, copy=True).requires_grad_() for x in bf16[:3])
        fa.flash_attention(tq, tk, tv).backward(bf16[3].to(dtype))
        return [t.grad.float() for t in (tq, tk, tv)]

    f32 = grads(torch.float32)

    def rel_errors():
        return [((a - w).norm() / w.norm()).item() for a, w in zip(grads(torch.bfloat16), f32)]

    assert max(rel_errors()) < 1e-2
    delta_f32 = fa._delta
    monkeypatch.setattr(
        fa, "_delta", lambda out, dout: delta_f32(out.bfloat16(), dout)
    )
    dq_err, dk_err, dv_err = rel_errors()
    assert min(dq_err, dk_err) > 5e-2 and dv_err < 1e-2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _emulated_kernel_grads(q, k, v, g, key_tile, split_p, keep=None):
    """dq, dk, dv as the Hopper kernels compute them, in f32 on the CPU.
    q, k, v, g hold bf16 values. The products take bf16 operands with f32
    sums (exact products, as on the tensor cores). K1 runs the online
    softmax over `key_tile`-key tiles and feeds P to P.V as bf16 hi + lo
    (`split_p`) or as bf16 alone; l sums the f32 p; O stays f32. delta
    comes from that O. K2 rounds P to bf16 for P^T dO and dS to bf16 for
    dS^T Q; K3 rounds dS to bf16 for dS K. keep ([s, s] bool, True =
    attend), where given, masks the scores as a causal mask does."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if keep is not None:
        scores = torch.where(keep, scores, fa.NEG_INF)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, key_tile):
        tile = scores[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = _bf16(p)
        weights = hi + _bf16(p - hi) if split_p else hi
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", weights, v[:, k0:k0 + key_tile])
        m = m_new
    out = (acc / l).transpose(1, 2)  # [b, s, h, d] in f32
    lse = (m + torch.log(l))[..., 0]
    delta = fa._delta(out, g)
    p = torch.exp(scores - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, v) - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), g)
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k) * scale
    return dq, dk, dv


@pytest.mark.parametrize("head_dim", [64, 128])
def test_kernel_numerics_keep_common_part_gradients_within_one_percent(head_dim):
    """K1-K3 round their probability operands (P, dS) to bf16 before
    the second products. On values with a large common part (the case
    above), emulating that holds dq, dk and dv within 1% of the f32
    gradients when K1 carries P as bf16 hi + lo, as it does; with P
    rounded to bf16 alone in K1, O's weights no longer sum to l, delta
    drifts from sum_k p dp, and dq moves past 1%. K1's key tile is 128
    at head_dim 64 and 64 at 128."""
    rng = np.random.default_rng(0)
    b, s, h = 2, 128, 2
    q, k, g = (rng.standard_normal((b, s, h, head_dim)) for _ in range(3))
    v = 4.0 + 0.05 * rng.standard_normal((b, s, h, head_dim))
    q, k, v, g = (_bf16(torch.tensor(x, dtype=torch.float32)) for x in (q, k, v, g))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention(tq, tk, tv).backward(g)
    f32 = [t.grad for t in (tq, tk, tv)]
    key_tile = 128 if head_dim == 64 else 64

    def rel_errors(split_p):
        got = _emulated_kernel_grads(q, k, v, g, key_tile, split_p)
        return [((a - w).norm() / w.norm()).item() for a, w in zip(got, f32)]

    assert max(rel_errors(split_p=True)) < 1e-2
    assert rel_errors(split_p=False)[0] > 1e-2


@pytest.mark.parametrize("drop_tile", [False, True], ids=["kernel", "tile-dropped"])
def test_row_check_tells_a_dropped_causal_tile_from_rounding(drop_tile):
    """chip_smoke.py holds K1-K3 at GPT-small's causal shape against the
    f32 plain gradients one (batch, row, head) slice at a time. The
    kernels' roundings, emulated here under a causal mask at seq 1024 and
    head_dim 128, stay within that check's ROW_RTOL; the same numerics
    with one 64-key tile hidden from the late rows (a wrong causal skip
    bound) exceed it."""
    import chip_smoke

    b, s, h, d = 1, 1024, 2, 128
    rng = np.random.default_rng(9)
    q, k, v, g = (
        _bf16(torch.tensor(rng.standard_normal((b, s, h, d)), dtype=torch.float32))
        for _ in range(4)
    )
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention(tq, tk, tv, causal=True).backward(g)
    f32 = [t.grad for t in (tq, tk, tv)]
    keep = causal.clone()
    if drop_tile:
        keep[700:, 256:320] = False
    got = _emulated_kernel_grads(q, k, v, g, 64, split_p=True, keep=keep)
    worst = max(chip_smoke.row_errors(_bf16(a), w)["worst_row_rel"] for a, w in zip(got, f32))
    if drop_tile:
        assert worst > 4 * chip_smoke.ROW_RTOL
    else:
        assert worst < chip_smoke.ROW_RTOL / 4


@pytest.mark.parametrize("shape", [(4, 512, 12, 64), (4, 333, 6, 128)])
@pytest.mark.parametrize("kind", ["none", "padding", "causal"])
def test_bf16_ds_keeps_dq_within_two_ulps(shape, kind):
    """K3 rounds dS to bf16 before dQ += dS K; the plain version keeps
    dS in f32. At chip_smoke.py's check shapes (seq 333: a ragged last
    tile) the emulated kernel dq stays within chip_smoke.py's tolerance
    of the plain version's: 2 bf16 ulps of the largest magnitude."""
    b, s, h, d = shape
    rng = np.random.default_rng(s + d)
    q, k, v, g = (
        _bf16(torch.tensor(rng.standard_normal(shape), dtype=torch.float32))
        for _ in range(4)
    )
    mask = None
    if kind == "padding":
        lengths = np.array([0, s - 37, s - 74, s])  # one row all padding
        mask = torch.tensor(np.arange(s)[None, :] < lengths[:, None], dtype=torch.float32)
    causal = kind == "causal"
    scale = 1.0 / math.sqrt(d)
    out, lse = fa._forward_f32(q, k, v, mask, causal, scale)
    delta = fa._delta(out, g)
    _, ds = fa._backward_probs(q, k, v, mask, g, lse, delta, causal, scale)
    want = fa.flash_backward_dq_reference(q, k, v, mask, g, lse, delta, causal, scale)
    got = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k) * scale
    want, got = _bf16(want), _bf16(got)  # both leave the kernel in bf16
    tol = 2 * 2.0**-8 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never run a plain version: a tensor off the card is
    refused before anything is built."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_fwd(q, q, q, None, False, 0.125)
    stats = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_bwd_dkv(q, q, q, None, q, stats, stats, False, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_bwd_dq(q, q, q, None, q, stats, stats, False, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [200, 333])
def test_cuda_kernels_match_plain_versions(head_dim, causal, s):
    """K1-K3 on the card against their plain versions in bf16, with a
    ragged padding mask, at sequence lengths whose last K/V and Q tiles
    TMA zero-fills: 2 bf16 ulps of the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h = 2, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (
        torch.randn((b, s, h, head_dim), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
        for _ in range(4)
    )
    mask = torch.ones((b, s), device="cuda")
    mask[1, 150:] = 0.0
    scale = 1.0 / math.sqrt(head_dim)
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, mask, causal, scale)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    delta = fa._delta(out_f32, g)
    args = (q, k, v, mask, g, lse, delta, causal, scale)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(*args)
    ref_dq = fa.flash_backward_dq_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0.0)
    for got, want in ((out, ref_out), (dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        tol = 2 * 2.0**-8 * max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0.0)


@pytest.mark.cuda
def test_cuda_float32_takes_the_plain_route():
    """The kernels take bf16 only: an f32 tensor on the card goes to
    dot_product_attention, as a shape supports() refuses does, and
    launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn((2, 96, 2, 64), generator=gen, device="cuda") for _ in range(3)
    )
    mask = torch.ones((2, 1, 1, 96), device="cuda")
    before = dict(kernels.LAUNCHES)
    got = fa.flash_attention(q, k, v, mask)
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(got, dot_product_attention(q, k, v, mask), atol=0.0, rtol=0.0)
