"""The port's 3x3 conv (tf_operator_tpu_torch/ops/conv_bn.py) held against
the JAX package's, on the same numpy inputs.

On the CPU the port's conv3x3_s1 runs the kernels' plain f32 versions
and the JAX side runs its Pallas kernels in interpret mode, as
tests/test_attention.py::TestPallasConv does, at that test's shapes.
The tolerances are the reference's own: 1e-4 on the forward, 2e-3 on
the gradients. The test of the CUDA kernels against their plain
versions needs a card and skips without one; on a machine with a card
and no JAX run it with
`python -m pytest --noconftest tests/test_torch_conv.py -m cuda`.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.pallas.conv_bn import conv3x3_s1 as jax_conv
except ImportError:  # a card machine without JAX runs only the cuda tests
    jax = None

from tf_operator_tpu_torch.ops import conv_bn
from tf_operator_tpu_torch.ops import kernels

FWD_ATOL = 1e-4
GRAD_ATOL = 2e-3


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, shape[3], cout)) / np.sqrt(shape[3])).astype(np.float32)
    return x, k


@pytest.mark.parametrize(
    "shape,cout",
    [((2, 8, 8, 64), 64), ((4, 4, 4, 128), 64), ((1, 16, 8, 64), 128)],
)
def test_forward_matches_jax(needs_jax, shape, cout):
    x, k = _inputs(shape, cout, 0)
    assert conv_bn.supports(shape, k.shape, (1, 1), torch.float32, "cpu")
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(k), True))
    got = conv_bn.conv3x3_s1(torch.tensor(x), torch.tensor(k))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=FWD_ATOL)


@pytest.mark.parametrize("shape,cout", [
    ((2, 8, 8, 64), 64),
    ((16, 8, 8, 64), 64),
    ((2, 4, 4, 256), 512),
], ids=["single-block", "multi-image-block", "cout-blocked"])
def test_gradients_match_jax(needs_jax, shape, cout):
    """dx (the forward on the cotangent with the flipped, transposed
    kernel) and dW (the nine x_shift^T g taps) of sum(y^2)."""
    x, k = _inputs(shape, cout, 2)

    def loss(x, k):
        return (jax_conv(x, k, True).astype(jnp.float32) ** 2).sum()

    val, (gx, gk) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.tensor(x, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    out = (conv_bn.conv3x3_s1(xt, kt) ** 2).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=GRAD_ATOL, rtol=GRAD_ATOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), atol=GRAD_ATOL, rtol=GRAD_ATOL)


def test_plain_versions_match_torch_conv():
    """The plain versions against torch's own conv and its gradients, in
    f64 so that only the algorithm is compared: a wrong tap order, flip
    or transpose cannot hide inside a tolerance."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 5, 7, 64)))
    k = torch.tensor(rng.standard_normal((3, 3, 64, 128)))
    g = torch.tensor(rng.standard_normal((2, 5, 7, 128)))
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = k.permute(3, 2, 0, 1)
    want = torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(conv_bn.conv3x3_fwd_plain(x, k).double(), want)
    want_dw = torch.nn.grad.conv2d_weight(
        x_nchw, w_oihw.shape, g.permute(0, 3, 1, 2), padding=1
    ).permute(2, 3, 1, 0)
    torch.testing.assert_close(conv_bn.conv3x3_dw_plain(x, g).double(), want_dw)
    dx = conv_bn.conv3x3_fwd_plain(g, k.flip(0, 1).transpose(2, 3))
    want_dx = torch.nn.grad.conv2d_input(
        x_nchw.shape, w_oihw, g.permute(0, 3, 1, 2), padding=1
    ).permute(0, 2, 3, 1)
    torch.testing.assert_close(dx.double(), want_dx)


@pytest.mark.parametrize("x_shape,w_shape,strides,dtype,device,ok", [
    ((2, 8, 8, 64), (3, 3, 64, 64), (1, 1), torch.bfloat16, "cuda", True),
    ((256, 7, 7, 512), (3, 3, 512, 512), (1, 1), torch.bfloat16, "cuda", True),
    ((3, 8, 8, 64), (3, 3, 64, 128), (1, 1), torch.float32, "cpu", True),
    ((2, 8, 8, 64), (3, 3, 64, 64), (2, 2), torch.bfloat16, "cuda", False),
    ((2, 8, 8, 63), (3, 3, 63, 64), (1, 1), torch.bfloat16, "cuda", False),
    ((2, 8, 8, 64), (3, 3, 64, 96), (1, 1), torch.bfloat16, "cuda", False),
    ((2, 8, 8, 64), (1, 1, 64, 64), (1, 1), torch.bfloat16, "cuda", False),
    ((2, 8, 8, 64), (3, 3, 64, 64), (1, 1), torch.float32, "cuda", False),
    ((2, 8, 8, 64), (3, 3, 64, 64), (1, 1), torch.float16, "cuda", False),
], ids=["bf16", "stage3-n256", "cpu-f32", "stride2", "channels", "cout",
        "1x1", "cuda-f32", "cuda-f16"])
def test_supports_gates(x_shape, w_shape, strides, dtype, device, ok):
    assert conv_bn.supports(x_shape, w_shape, strides, dtype, device) is ok


def test_supports_takes_resnet50_stride1_convs():
    """Every stride-1 3x3 conv of ResNet-50 at batch 256, as the
    reference's supports() takes them, and any N (no n % tn rule)."""
    stages = ((56, 64), (28, 128), (14, 256), (7, 512))
    counts = (3, 3, 5, 2)  # stride-1 Conv_1s per stage at sizes 3, 4, 6, 3
    taken = 0
    for (size, c), count in zip(stages, counts):
        for n in (256, 1, 3, 255):
            assert conv_bn.supports((n, size, size, c), (3, 3, c, c), (1, 1))
        taken += count
    assert taken == 13


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3_fwd(x, k)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3_dw(x, x)
    assert kernels.LAUNCHES == before


def test_cpu_route_never_launches():
    x, k = _inputs((1, 4, 4, 64), 64, 3)
    before = dict(kernels.LAUNCHES)
    xt = torch.tensor(x, requires_grad=True)
    conv_bn.conv3x3_s1(xt, torch.tensor(k)).sum().backward()
    assert kernels.LAUNCHES == before


# shapes whose K4 and K5 plans are checked: ResNet-50's stages at the
# bench's batch, and ragged ones
PLAN_CASES = [
    (256, 56, 56, 64, 64), (256, 28, 28, 128, 128), (256, 14, 14, 256, 256),
    (256, 7, 7, 512, 512), (8, 7, 7, 64, 64), (1, 3, 11, 512, 64), (3, 9, 9, 64, 128),
]


@pytest.mark.parametrize("n,h,w,c,cout", PLAN_CASES)
def test_dw_plan_covers_every_pixel_once(n, h, w, c, cout):
    """K5's patches, walked W first, then H, then N, and cut into runs
    of consecutive patches, one run per split: every run holds at least
    one patch, and the patches cover each of the N*H*W pixels exactly
    once (the kernel zero-fills what lies outside). Each box holds
    DW_PATCH pixels and fits a TMA box (at most 256 a side)."""
    plan = kernels.dw_plan(n, h, w, c, cout)
    assert plan.wb * plan.hb * plan.nb == kernels.DW_PATCH
    assert max(plan.wb, plan.hb, plan.nb) <= 256
    n_w, n_h = -(-w // plan.wb), -(-h // plan.hb)
    assert plan.patches == n_w * n_h * -(-n // plan.nb)
    runs = [range(s * plan.per_split, min((s + 1) * plan.per_split, plan.patches))
            for s in range(plan.splits)]
    assert all(len(run) > 0 for run in runs)
    assert [p for run in runs for p in run] == list(range(plan.patches))
    count = np.zeros((n, h, w), np.int32)
    for p in range(plan.patches):
        w0 = p % n_w * plan.wb
        h0 = p // n_w % n_h * plan.hb
        n0 = p // (n_w * n_h) * plan.nb
        count[n0:n0 + plan.nb, h0:h0 + plan.hb, w0:w0 + plan.wb] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("n,h,w,c,cout", PLAN_CASES + [(3, 7, 7, 512, 256)])
def test_fwd_plan_covers_every_pixel_once(n, h, w, c, cout):
    """K4's boxes, walked W first, then H, then N, cover each of the
    N*H*W output pixels exactly once (the kernel's TMA store drops what
    lies outside). Each box holds FWD_PIXELS pixels and fits a TMA box
    (at most 256 a side); the tile width, 64 or 128 output channels,
    divides Cout."""
    plan = kernels.fwd_plan(n, h, w, c, cout)
    assert plan.wb * plan.hb * plan.nb == kernels.FWD_PIXELS
    assert max(plan.wb, plan.hb, plan.nb) <= 256
    assert plan.bn in (64, 128) and cout % plan.bn == 0
    n_w, n_h = -(-w // plan.wb), -(-h // plan.hb)
    assert plan.boxes == n_w * n_h * -(-n // plan.nb)
    count = np.zeros((n, h, w), np.int32)
    for box in range(plan.boxes):
        w0, h0, n0 = _box_origin(box, plan, n_w, n_h)
        count[n0:n0 + plan.nb, h0:h0 + plan.hb, w0:w0 + plan.wb] += 1
    assert (count == 1).all()


def _box_origin(box, plan, n_w, n_h):
    """(w0, h0, n0) of K4's box number `box` (conv_bn.cu, K4's prologue)."""
    return box % n_w * plan.wb, box // n_w % n_h * plan.hb, box // (n_w * n_h) * plan.nb


def _emulated_fwd(x, k, plan):
    """K4's walk in numpy: for each box and tile of bn output channels,
    for each (tap, 64 input channels) step, the box of x at the tap's
    shifted coordinates with zeros outside the tensor (TMA's zero fill),
    as 128 rows [pixel][64 channels], times the [64, bn] slab of w,
    summed in f32; then only the box's pixels inside the tensor are
    stored."""
    n, h, w, c = x.shape
    cout = k.shape[3]
    n_w, n_h = -(-w // plan.wb), -(-h // plan.hb)
    n_n = -(-n // plan.nb)
    # x inside a zero frame wide enough for every shifted box
    xp = np.zeros((n_n * plan.nb, n_h * plan.hb + 2, n_w * plan.wb + 2, c), np.float32)
    xp[:n, 1:h + 1, 1:w + 1] = x
    y = np.full((n, h, w, cout), np.nan, np.float32)
    for box in range(plan.boxes):
        w0, h0, n0 = _box_origin(box, plan, n_w, n_h)
        for co0 in range(0, cout, plan.bn):
            acc = np.zeros((kernels.FWD_PIXELS, plan.bn), np.float32)
            for step in range(9 * (c // 64)):
                tap, slab = divmod(step, c // 64)
                dy, dx, c0 = tap // 3, tap % 3, slab * 64
                # output (h0 + j, w0 + i) reads x at (h0 + j + dy - 1, w0 + i + dx - 1),
                # which is xp at (h0 + j + dy, w0 + i + dx)
                a = xp[n0:n0 + plan.nb, h0 + dy:h0 + dy + plan.hb, w0 + dx:w0 + dx + plan.wb,
                       c0:c0 + 64].reshape(kernels.FWD_PIXELS, 64)
                acc += a @ k[dy, dx, c0:c0 + 64, co0:co0 + plan.bn]
            tile = acc.reshape(plan.nb, plan.hb, plan.wb, plan.bn)
            vn, vh, vw = min(plan.nb, n - n0), min(plan.hb, h - h0), min(plan.wb, w - w0)
            y[n0:n0 + vn, h0:h0 + vh, w0:w0 + vw, co0:co0 + plan.bn] = tile[:vn, :vh, :vw]
    return y


@pytest.mark.parametrize("shape,cout", [((3, 9, 9, 64), 128), ((2, 8, 8, 128), 64)])
def test_emulated_fwd_walk_matches_plain_version(shape, cout):
    """The kernel's walk (boxes, shifted zero-filled reads, per-step
    slabs, clipped store), emulated at the plan's box and tile width
    (128 and 64 output channels at these two shapes), equals the plain
    version within 1e-5 of its largest magnitude (the two sum in
    another order)."""
    x, k = _inputs(shape, cout, 7)
    want = conv_bn.conv3x3_fwd_plain(torch.tensor(x), torch.tensor(k)).numpy()
    got = _emulated_fwd(x, k, kernels.fwd_plan(*shape, cout))
    assert np.isfinite(got).all()  # every pixel stored
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((8, 56, 56, 64), 64), ((8, 28, 28, 128), 128), ((8, 14, 14, 256), 256),
    ((8, 7, 7, 512), 512), ((2, 8, 8, 128), 64), ((2, 4, 4, 256), 512),
    ((3, 5, 9, 64), 128), ((3, 9, 9, 64), 128), ((3, 7, 7, 512), 256), ((1, 3, 11, 512), 64),
])
def test_cuda_kernels_match_plain_versions(shape, cout):
    """K4 forward, K4 as dx and K5 on the card against their plain
    versions in bf16: 2 bf16 ulps of the largest magnitude for the bf16
    outputs; K5's f32 dW, summed in another order, within 1e-4 of its
    largest magnitude, and bit-equal to itself on a rerun."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / c**0.5).bfloat16()
    g = torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
    k_flip = k.flip(0, 1).transpose(2, 3).contiguous()
    pairs = [
        (kernels.conv3x3_fwd(x, k), conv_bn.conv3x3_fwd_plain(x, k), 2 * 2.0**-8),
        (kernels.conv3x3_fwd(g, k_flip), conv_bn.conv3x3_fwd_plain(g, k_flip), 2 * 2.0**-8),
        (kernels.conv3x3_dw(x, g), conv_bn.conv3x3_dw_plain(x, g), 1e-4),
    ]
    again = kernels.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    assert torch.equal(again, pairs[2][0])  # split-K summed in a fixed order
    for got, want, rtol in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = rtol * max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0.0)


@pytest.mark.cuda
def test_cuda_float32_takes_the_torch_conv():
    """The kernels take bf16 only: PallasConv3x3 routes an f32 tensor on
    the card to the torch conv and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tf_operator_tpu_torch.models.resnet import PallasConv3x3

    conv = PallasConv3x3(64, 64, dtype=torch.float32).cuda()
    x = torch.randn((2, 64, 8, 8), device="cuda").to(memory_format=torch.channels_last)
    before = dict(kernels.LAUNCHES)
    out = conv(x)
    assert kernels.LAUNCHES == before
    want = torch.nn.functional.conv2d(x, conv.kernel.permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(out, want, atol=0.0, rtol=0.0)
