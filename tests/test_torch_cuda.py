"""The CUDA kernels against their plain PyTorch versions on the same card:
K1/K2 and K3a/K3b of the front-end (csrc/ee_fused.cu), K4 of the
GEMM-conv (csrc/gemm_conv.cu). Imports no jax; on a machine with a CUDA
device and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a CUDA device every test here skips."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch

from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
from edge_enhancement_tpu_torch.ops.cuda import gemm_conv as G
from edge_enhancement_tpu_torch.ops.square import add_square_draws, kernel_layout

pytestmark = pytest.mark.cuda

EPS = 0.062745098039216
# K1: the edge maps agree exactly (same rounding order), the HFS products
# sum in another order: ~1e-6 on values of order 1. K2: the same sums,
# scaled by at most 1/|g| < 1/high = 3.4
FWD_TOL, BWD_TOL = 2e-5, 1e-4
# The bfloat16 forms round where the plain versions do, on float32 sums in
# another order: a sum that lies within float32 noise of a bfloat16 rounding
# boundary rounds the other way, so out and y are at most one bf16 ulp off
# (and the edge maps exact). dx = dx_hfs + dx_canny rounds once, so one ulp
# of the HFS part can be more ulps of a small dx: at most BF16_DX_SHARE of
# dx more than one ulp off, and none more than BF16_DX_REL of the largest
# |dx|. K1 computes its sums in the plain version's order where the order
# can change the rounding, so it gives the plain version's bits; K2's sums
# run on the tensor cores in their own order (on an H100, 0.005-0.02% of dx
# more than one ulp off at 64 to 288 px).
BF16_DX_REL, BF16_DX_SHARE = 2.0 ** -7, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _consts(square):
    return F.FusedConsts(r=8, eps=EPS, w=1.0, alpha=0.0, high=76 / 255,
                         sigma=1.0, square=square)


def _operands(shape, square, dev, seed=0):
    """x (B, C, H, W) with a constant patch (|g| = 0) and exact 0/1 pixels,
    the kernel-layout square draws, and a cotangent u."""
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x[:, :, 2:h // 3, 2:w // 3] = 0.5
    x[0, :, h // 2:, : w // 4] = 1.0
    x[-1, :, h // 2:, w // 2:] = 0.0
    x = torch.from_numpy(x).to(dev)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    st = sqd = None
    if square:
        gen = torch.Generator(device=dev).manual_seed(seed)
        st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), EPS)
    return x, st, sqd, u


# the square perturbation assumes square images, as the reference does.
# Row bands of 32: one whole band, one ragged band (30 and 28: neither a
# multiple of 4 nor of the band; MNIST's one channel), several bands with a
# ragged last one (72: 3 bands, the last of 8 rows; 100: 4 bands, the last
# of 4 rows and columns past a 64-column panel), and the ImageNet sizes
# 224 and 288 (7 and 9 whole bands)
# and the fast-AT recipes' 128 px (4 bands, or 4 column bands in bfloat16)
@pytest.mark.parametrize("shape,square", [((4, 3, 32, 32), True),
                                          ((4, 3, 32, 32), False),
                                          ((2, 3, 24, 40), False),
                                          ((1, 3, 224, 224), True),
                                          ((1, 3, 288, 288), False),
                                          ((2, 1, 28, 28), False),
                                          ((2, 3, 30, 30), True),
                                          ((2, 3, 72, 72), True),
                                          ((1, 3, 100, 100), False),
                                          ((2, 3, 128, 128), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, shape, square, dtype):
    x, st, sqd, u = _operands(shape, square, cuda)
    if dtype == torch.bfloat16:
        _check_bf16(*(None if t is None else t.to(dtype) for t in (x, st, sqd, u)), square)
        return
    k = _consts(square)
    out_k, y_k = F.ee_fused_fwd(x, st, sqd, k)
    out_p, y_p = F.ee_fused_fwd_plain(x, st, sqd, k)
    torch.testing.assert_close(out_k, out_p, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(y_k, y_p, atol=FWD_TOL, rtol=0)
    dx_k = F.ee_fused_bwd(u, x, st, sqd, y_p, k)
    torch.testing.assert_close(dx_k, F.ee_fused_bwd_plain(u, x, st, sqd, y_p, k),
                               atol=BWD_TOL, rtol=0)
    xa = x.clone().requires_grad_()
    (g_auto,) = torch.autograd.grad((F.ee_fused_fwd_plain(xa, st, sqd, k)[0] * u).sum(),
                                    [xa])
    torch.testing.assert_close(dx_k, g_auto, atol=BWD_TOL, rtol=0)
    assert dx_k.abs().max() > 0.1


def _bf16_pair(x, st, sqd, u, k):
    """K1 and K2 in bfloat16 against their plain versions, within the limits
    above; K2 on the plain forward's y, so both see the same clip mask."""
    out_k, y_k = F.ee_fused_fwd(x, st, sqd, k)
    out_p, y_p = F.ee_fused_fwd_plain(x, st, sqd, k)
    assert out_k.dtype == y_k.dtype == torch.bfloat16
    assert (y_k.float() - y_p.float()).abs().max() < 0.5     # an edge flip moves y by 1
    assert F.bf16_ulps(out_k, out_p).max() <= 1
    assert F.bf16_ulps(y_k, y_p).max() <= 1
    dx_k = F.ee_fused_bwd(u, x, st, sqd, y_p, k)
    dx_p = F.ee_fused_bwd_plain(u, x, st, sqd, y_p, k)
    assert dx_k.dtype == torch.bfloat16 and dx_k.float().abs().max() > 0.1
    assert (F.bf16_ulps(dx_k, dx_p) > 1).float().mean() <= BF16_DX_SHARE
    assert ((dx_k.float() - dx_p.float()).abs().max()
            <= BF16_DX_REL * dx_p.float().abs().max())


def _check_bf16(x, st, sqd, u, square):
    """K1/K2 in bfloat16 against their plain versions (the limits above),
    then through the autograd.Function: one launch of each bfloat16 form."""
    k = _consts(square)
    F.reset_launches()
    _bf16_pair(x, st, sqd, u, k)
    xa = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((F.ee_fused(xa, st, sqd, k) * u).sum(), [xa])
    assert g.dtype == torch.bfloat16
    assert F.LAUNCHES == {"ee_fused_fwd": 0, "ee_fused_bwd": 0,
                          "ee_fused_fwd_bf16": 2, "ee_fused_bwd_bf16": 2,
                          "canny_fused_fwd": 0, "canny_fused_bwd": 0,
                          "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}


# The bfloat16 K1/K2 (products on the tensor cores, in passes of 128
# columns; bands of 32 rows, or columns for K2) at fast-AT's 224 and 288 px
# (7 and 9 bands; 224 = 128 + 96 and 288 = 2 x 128 + 32 columns, last passes
# with idle warps), one partial band (30: W % 8 != 0, the element-by-element
# loads and stores), and ragged last bands (72 = 2 x 32 + 8; 100 = 3 x 32 + 4,
# also W % 8 != 0), square on and off: one launch of each entry point
@pytest.mark.parametrize("shape", [(1, 3, 224, 224), (1, 3, 288, 288), (2, 3, 30, 30),
                                   (2, 3, 72, 72), (1, 3, 100, 100)])
@pytest.mark.parametrize("square", [True, False])
def test_bf16_kernels_at_fast_at_and_ragged_sizes(cuda, shape, square):
    x, st, sqd, u = (None if t is None else t.to(torch.bfloat16)
                     for t in _operands(shape, square, cuda, seed=7))
    F.reset_launches()
    _bf16_pair(x, st, sqd, u, _consts(square))
    assert F.LAUNCHES == {"ee_fused_fwd": 0, "ee_fused_bwd": 0,
                          "ee_fused_fwd_bf16": 1, "ee_fused_bwd_bf16": 1,
                          "canny_fused_fwd": 0, "canny_fused_bwd": 0,
                          "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}


def test_autograd_function_launches_each_kernel_once(cuda):
    x, st, sqd, u = _operands((2, 3, 32, 32), True, cuda, seed=1)
    k = _consts(True)
    F.reset_launches()
    xa = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((F.ee_fused(xa, st, sqd, k) * u).sum(), [xa])
    assert F.LAUNCHES == {"ee_fused_fwd": 1, "ee_fused_bwd": 1,
                          "ee_fused_fwd_bf16": 0, "ee_fused_bwd_bf16": 0,
                          "canny_fused_fwd": 0, "canny_fused_bwd": 0,
                          "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}
    _, y = F.ee_fused_fwd(x, st, sqd, k)
    torch.testing.assert_close(g, F.ee_fused_bwd(u, x, st, sqd, y, k), atol=0, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    k = _consts(False)
    F.reset_launches()
    bad = [torch.zeros(1, 3, 32, 32, device=cuda, dtype=torch.float64),
           torch.zeros(1, 3, 32, 32, device=cuda, dtype=torch.float16),
           torch.zeros(1, 3, 32, 64, device=cuda)[..., ::2],     # not contiguous
           torch.zeros(1, 80, 32, 32, device=cuda),              # halo tile above shared memory
           torch.zeros(1, 15, 64, 64, device=cuda)]              # fits K1, not K2
    for x in bad:
        with pytest.raises(ValueError):
            F.ee_fused_fwd(x, None, None, k)
    x = torch.zeros(1, 3, 32, 32, device=cuda)
    with pytest.raises(ValueError):                                # missing draws
        F.ee_fused_fwd(x, None, None, _consts(True))
    st, sqd = kernel_layout(add_square_draws((1, 32, 32, 3), torch.Generator(
        device=cuda).manual_seed(0)), EPS)
    with pytest.raises(ValueError):                   # float32 draws with a bfloat16 x
        F.ee_fused_fwd(x.bfloat16(), st, sqd, _consts(True))
    assert all(v == 0 for v in F.LAUNCHES.values())


# K3a: the same operations in the same order as the plain version; K3b:
# stencil adjoints summed in another order, scaled by at most 1/|g|
CANNY_BWD_TOL = 1e-4


def _canny_check(x, alpha, cuda, sigma=1.0):
    """K3a exactly its plain version; K3b within CANNY_BWD_TOL of the plain
    adjoint and of autograd of the plain forward. Returns (edge map, dx)."""
    b, c, h, w = x.shape
    u = torch.randn((b, 1, h, w), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    high = 76 / 255
    outs_k = F.canny_fused_fwd(x, high, sigma, alpha)
    outs_p = F.canny_fused_fwd_plain(x, high, sigma, alpha)
    for got, want in zip(outs_k, outs_p):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    _, mag, gx, gy = outs_k
    dx_k = F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha)
    torch.testing.assert_close(
        dx_k, F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma, alpha),
        atol=CANNY_BWD_TOL, rtol=0)
    xa = x.clone().requires_grad_()
    (g_auto,) = torch.autograd.grad(
        (F.canny_fused_fwd_plain(xa, high, sigma, alpha)[0] * u).sum(), [xa])
    torch.testing.assert_close(dx_k, g_auto, atol=CANNY_BWD_TOL, rtol=0)
    return outs_k[0], dx_k


# tiles of CANNY_ROWS x CANNY_COLS (16 x 32): whole tiles, ragged tiles with
# W not a multiple of 4 (the 4-byte paths), one channel (MNIST's 28 px), an
# image wider and taller than a tile with ragged last tiles, one tile
# smaller than the halo, 224 px; and sigma 0.05, whose Gaussian has the
# centre tap alone nonzero (the plain blur skips its zeros, the kernels'
# multiply them)
@pytest.mark.parametrize("shape,alpha,sigma", [((4, 3, 32, 64), 0.0, 1.0),
                                               ((3, 3, 37, 45), 0.1, 1.0),
                                               ((2, 1, 28, 28), 0.3, 1.0),
                                               ((2, 3, 100, 100), 0.0, 1.0),
                                               ((2, 3, 2, 5), 0.0, 1.0),
                                               ((1, 3, 224, 224), 0.0, 1.0),
                                               ((2, 3, 37, 45), 0.0, 0.05)])
def test_canny_kernels_match_plain(cuda, shape, alpha, sigma):
    if sigma == 0.05:
        assert (F.gaussian_taps(sigma, "cpu") == 0).sum() == 8
    x, _, _, _ = _operands(shape, False, cuda)
    edge, dx_k = _canny_check(x, alpha, cuda, sigma)
    assert 0 < edge.mean() < 1
    assert dx_k.abs().max() > 0.1


@pytest.mark.parametrize("shape,alpha,sigma", [((4, 3, 32, 64), 0.0, 1.0),
                                               ((3, 3, 37, 45), 0.1, 1.0),
                                               ((2, 1, 28, 28), 0.3, 1.0),
                                               ((2, 3, 100, 100), 0.0, 1.0),
                                               ((2, 3, 2, 5), 0.0, 1.0),
                                               ((2, 3, 128, 128), 0.0, 1.0),
                                               ((2, 3, 37, 45), 0.0, 0.05)])
def test_canny_bf16_kernels_match_plain(cuda, shape, alpha, sigma):
    """K3a/K3b in bfloat16 give their plain bfloat16 versions' bits: K3a's
    four outputs, and K3b's dx (its adjoint rounds tap by tap, as the plain
    version and JAX do; the float32 K3b sums in another order). The same
    tiles as float32, and fast-AT's 128 px."""
    x, _, _, _ = _operands(shape, False, cuda)
    x = x.bfloat16()
    b, c, h, w = shape
    u = torch.randn((b, 1, h, w), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)).bfloat16()
    high = 76 / 255
    outs_k = F.canny_fused_fwd(x, high, sigma, alpha)
    for got, want in zip(outs_k, F.canny_fused_fwd_plain(x, high, sigma, alpha)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    _, mag, gx, gy = outs_k
    dx_k = F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha)
    assert dx_k.dtype == torch.bfloat16
    torch.testing.assert_close(dx_k, F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma,
                                                             alpha), atol=0, rtol=0)
    assert 0 < outs_k[0].float().mean() < 1 and dx_k.float().abs().max() > 0.01


# the bfloat16 pair's own 32 x 32 tiles at widths of every residue mod 4 and
# 8: the summed blur's edge columns are set where the Sobel reads them, the
# image's right edge at each lane of a quad; a 1 x 1 image; rows past a tile;
# the most channels canny_geometry admits in bfloat16 (66)
@pytest.mark.parametrize("shape", [(2, 3, 35, 39), (1, 3, 7, 3), (2, 2, 1, 1), (1, 3, 33, 67),
                                   (2, 3, 34, 34), (2, 3, 40, 64), (1, 1, 66, 97),
                                   (1, 66, 20, 20)])
def test_canny_bf16_kernels_at_odd_sizes(cuda, shape):
    """K3a/K3b in bfloat16 give their plain versions' bits where the image's
    edges fall anywhere in a tile."""
    x, _, _, _ = _operands(shape, False, cuda, seed=5)
    x = x.bfloat16()
    b, c, h, w = shape
    u = torch.randn((b, 1, h, w), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4)).bfloat16()
    high = 76 / 255
    outs_k = F.canny_fused_fwd(x, high, 1.0, 0.0)
    for got, want in zip(outs_k, F.canny_fused_fwd_plain(x, high, 1.0, 0.0)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    _, mag, gx, gy = outs_k
    dx_k = F.canny_fused_bwd(u, mag, gx, gy, c, high, 1.0, 0.0)
    torch.testing.assert_close(dx_k, F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, 1.0,
                                                             0.0), atol=0, rtol=0)


def test_canny_kernels_take_the_largest_channel_count(cuda):
    """The most channels canny_geometry admits run and agree; one more is
    refused before any launch, by K3a and by K3b."""
    c = F.canny_geometry(1, 20, 20).max_channels
    x, _, _, _ = _operands((1, c, 20, 20), False, cuda)
    edge, dx_k = _canny_check(x, 0.0, cuda)
    assert 0 < edge.mean() < 1 and dx_k.abs().max() > 0
    F.reset_launches()
    with pytest.raises(ValueError, match="channels"):
        F.canny_fused_fwd(torch.zeros((1, c + 1, 20, 20), device=cuda), 76 / 255, 1.0, 0.0)
    plane = torch.zeros((1, 1, 20, 20), device=cuda)
    with pytest.raises(ValueError, match="channels"):
        F.canny_fused_bwd(plane, plane, plane, plane, c + 1, 76 / 255, 1.0, 0.0)
    assert all(v == 0 for v in F.LAUNCHES.values())


# K1's bands (32 rows, 64-column strips) and K3a's 16 x 32 tiles: one whole
# band, and ragged last bands, strips and tiles (72 = 2 x 32 + 8 = 4 x 16 + 8
# = 64 + 8)
@pytest.mark.parametrize("shape", [(4, 3, 32, 32), (2, 3, 72, 72)])
def test_canny_edge_map_equals_k1s(cuda, shape):
    """K3a's edge map is K1's: with w = 1 and no square, y - hfs = edge."""
    x, _, _, _ = _operands(shape, False, cuda, seed=2)
    h, w = shape[2:]
    k = _consts(False)
    _, y = F.ee_fused_fwd(x, None, None, k)
    ar, ai, br, bi, _ = F.operators(h, w, 8, 1.0, cuda)
    from edge_enhancement_tpu_torch.ops.hfs import hfs_nchw
    edge = F.canny_fused_fwd(x, k.high, 1.0, 0.0)[0]
    torch.testing.assert_close((y - hfs_nchw(x, ar, ai, br, bi)).round(),
                               edge.expand_as(y), atol=0, rtol=0)


def test_gf_frontend_launches_only_k3(cuda):
    from edge_enhancement_tpu_torch.models import ee_frontend as tee
    x, _, _, _ = _operands((2, 3, 32, 32), False, cuda, seed=4)
    cfg = tee.EEConfig(r=8, w=1.0, high=76.0, type_canny="CannyFilter_step125_1",
                       with_gf=True, square=True, epsilon=EPS, n_queries=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    draws = add_square_draws((2, 32, 32, 3), gen)
    xa = x.permute(0, 2, 3, 1).contiguous().requires_grad_()
    F.reset_launches()
    out = tee.ee_frontend(xa, cfg, lambda shape: draws)
    out.sum().backward()
    assert F.LAUNCHES == {"ee_fused_fwd": 0, "ee_fused_bwd": 0,
                          "ee_fused_fwd_bf16": 0, "ee_fused_bwd_bf16": 0,
                          "canny_fused_fwd": 1, "canny_fused_bwd": 1,
                          "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}
    xc = x.permute(0, 2, 3, 1).cpu().requires_grad_()
    out_c = tee.ee_frontend(xc, cfg, lambda shape: tuple(d.cpu() for d in draws))
    out_c.sum().backward()
    torch.testing.assert_close(out.cpu(), out_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(xa.grad.cpu(), xc.grad, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["queries_f32", "gf_bf16", "queries_bf16"])
def test_k3_frontends_on_the_card_match_the_cpu(cuda, case):
    """The front-end's K3 paths, more than one square query and the edge
    map smoothed under the bf16 policy: one K3a and one K3b launch of the
    dtype's form and no other, out and dx as the CPU path's (float32:
    within the HFS products' summation order; bfloat16: out within one
    ulp, dx within the bf16 limits of K2)."""
    from edge_enhancement_tpu_torch.models import ee_frontend as tee
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    n = 1 if case.startswith("gf") else 3
    x, _, _, _ = _operands((2, 3, 32, 32), False, cuda, seed=5)
    cfg = tee.EEConfig(r=8, w=1.0, high=76.0, type_canny="CannyFilter_step125_1",
                       with_gf=case.startswith("gf"), square=True, epsilon=EPS, n_queries=n)
    draws = add_square_draws((2, 32, 32, 3), torch.Generator(device=cuda).manual_seed(0),
                             n_queries=n)
    xa = x.permute(0, 2, 3, 1).to(dtype).contiguous().requires_grad_()
    F.reset_launches()
    out = tee.ee_frontend(xa, cfg, lambda shape, **_: draws)
    out.float().sum().backward()
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    assert {k: v for k, v in F.LAUNCHES.items() if v} == {
        "canny_fused_fwd" + suffix: 1, "canny_fused_bwd" + suffix: 1}
    xc = xa.detach().cpu().requires_grad_()
    out_c = tee.ee_frontend(xc, cfg, lambda shape, **_: tuple(d.cpu() for d in draws))
    out_c.float().sum().backward()
    if dtype == torch.float32:
        torch.testing.assert_close(out.cpu(), out_c, atol=1e-5, rtol=0)
        torch.testing.assert_close(xa.grad.cpu(), xc.grad, atol=1e-4, rtol=0)
    else:
        assert F.bf16_ulps(out.cpu(), out_c).max() <= 1
        off = F.bf16_ulps(xa.grad.cpu(), xc.grad) > 1
        assert off.float().mean() <= BF16_DX_SHARE
        assert (xa.grad.cpu().float() - xc.grad.float()).abs().max() <= (
            BF16_DX_REL * xc.grad.float().abs().max())


# K4 vs its plain version on the same operands: float32 runs three TF32
# products (3xTF32, ~6e-6 on outputs of order 10, the plain version's
# float32 sums in another order included); bfloat16 both round a float32
# sum once, so one bf16 ulp (2^-7 relative) apart at most. Beyond the JAX
# tests' shapes, those that reach every masked path of the kernels: M not
# a multiple of the 128-row tile, C_out ragged (96) and two N tiles (192),
# a ragged channel chunk (C_in 24), several chunks a tap (128), and C_in 5
# (padded to 8 by the wrapper)
@pytest.mark.parametrize("shape", [(4, 16, 16, 64, 64), (2, 8, 8, 32, 64),
                                   (3, 16, 16, 64, 128), (2, 7, 9, 16, 32),
                                   (3, 7, 9, 64, 64), (2, 8, 8, 64, 96),
                                   (2, 8, 8, 64, 192), (2, 8, 8, 24, 64),
                                   (2, 8, 8, 128, 64), (2, 7, 9, 5, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain(cuda, shape, dtype):
    b, h, w, ci, co = shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((b, h, w, ci), generator=gen, device=cuda).to(dtype)
    wk = (0.1 * torch.randn((3, 3, ci, co), generator=gen, device=cuda)).to(dtype)
    G.reset_launches()
    got = G.conv_cgemm_nhwc(x, wk)
    want = G.conv_cgemm_nhwc_plain(x, wk)
    assert got.dtype == dtype and got.shape == (b, h, w, co)
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=1e-4, rtol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    xa = x.clone().requires_grad_()
    wa = wk.clone().requires_grad_()
    dy = torch.randn((b, h, w, co), generator=gen, device=cuda).to(dtype)
    dx, dw = torch.autograd.grad(G.conv3x3_cgemm(xa, wa), [xa, wa], dy)
    torch.testing.assert_close(
        dx.float(), G.conv_cgemm_nhwc_plain(dy, G._dgrad_weights(wk)).float(), **tol)
    key = "conv_cgemm_f32" if dtype == torch.float32 else "conv_cgemm_bf16"
    assert G.LAUNCHES[key] == 3          # the check above, forward, dgrad
    if dtype == torch.float32:
        xr = x.clone().requires_grad_()
        wr = wk.clone().requires_grad_()
        ref = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1),
                                         padding=1).permute(0, 2, 3, 1)
        dx_r, dw_r = torch.autograd.grad(ref, [xr, wr], dy)
        torch.testing.assert_close(dw, dw_r, atol=1e-3, rtol=1e-4)


def test_conv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    G.reset_launches()
    w = torch.zeros(3, 3, 8, 8, device=cuda)
    for x in (torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.float64),
              torch.zeros(1, 4, 8, 8, device=cuda)[:, :, ::2],
              torch.zeros(1, 4, 4, 6, device=cuda)):
        with pytest.raises(ValueError):
            G.conv_cgemm_nhwc(x, w)
    assert all(v == 0 for v in G.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_packed_launches_the_kernel_alone(cuda, dtype):
    """conv_cgemm_packed on weights packed once equals the op, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 8, 8, 64), generator=gen, device=cuda).to(dtype)
    wk = (0.1 * torch.randn((3, 3, 64, 64), generator=gen, device=cuda)).to(dtype)
    _, wp = G.pack_operands(x, wk)
    key = "conv_cgemm_f32" if dtype == torch.float32 else "conv_cgemm_bf16"
    G.reset_launches()
    got = G.conv_cgemm_packed(x, wp)
    assert G.LAUNCHES == {"conv_cgemm_f32": 0, "conv_cgemm_bf16": 0, key: 1}
    torch.testing.assert_close(got, G.conv_cgemm_nhwc(x, wk), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bf16_refuses_misaligned_views(cuda, dtype):
    """Both kernels load 16-byte chunks: a view one element off raises, and
    so does an unpadded C_in."""
    G.reset_launches()
    lead = (2,) if dtype == torch.float32 else ()
    w = torch.zeros(3, 3, 8, 8, device=cuda, dtype=dtype)
    x = torch.zeros(1 * 4 * 4 * 8 + 1, device=cuda, dtype=dtype)[1:]
    x = x.view(1, 4, 4, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError):
        G.conv_cgemm_nhwc(x, w)
    n = 8 * 72 * (2 if lead else 1)
    wp = torch.zeros(n + 1, device=cuda, dtype=dtype)[1:].view(*lead, 8, 72)
    with pytest.raises(ValueError):
        G.conv_cgemm_packed(torch.zeros(1, 4, 4, 8, device=cuda, dtype=dtype), wp)
    with pytest.raises(ValueError):                      # C_in % 8 != 0, unpadded
        G.conv_cgemm_packed(torch.zeros(1, 4, 4, 5, device=cuda, dtype=dtype),
                            torch.zeros(*lead, 8, 45, device=cuda, dtype=dtype))
    assert all(v == 0 for v in G.LAUNCHES.values())


def test_conv_f32_refuses_unsplit_weights(cuda):
    """The float32 kernel takes the (2, C_out, 9 C_in) TF32 pair only."""
    G.reset_launches()
    x = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        G.conv_cgemm_packed(x, G.pack_weights(torch.zeros(3, 3, 8, 8, device=cuda)))
    assert all(v == 0 for v in G.LAUNCHES.values())



# The eval battery (train/trainer.py::build_eval_step) on the card against
# the CPU path, one batch of resnet18_EE_square at 64 px on the same weights
# and draws (the square draws replayed per forward, the PGD and CW starts
# and the target offsets fixed), with TF32 off so that cuDNN computes in
# float32 as the CPU does (with cuDNN's default TF32 convolutions 2-13% of
# x_adv differed on an H100; with it off, none did). The card's x_adv may
# differ where a float32 input gradient changes sign between cuDNN and the
# CPU (the limit tests/test_torch_eval.py holds the port to JAX with); the
# card then goes on with the CPU's x_adv, so the adversarial metrics
# compare on one input.
# Launches: each forward runs K1 once, each input gradient K2 once.
EVAL_SHAPE, EVAL_XADV_SHARE = (4, 64, 64, 3), 0.01
EVAL_EE = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
               type_canny="CannyFilter_step125_1", epsilon=EPS, n_queries=1)
EVAL_BRANCHES = {   # fields, (K1, K2) launches of the batch
    "pgd": (dict(attack_method="PGD", num_steps=2), (4, 2)),
    "pgd_restarts": (dict(attack_method="PGD", num_steps=2, restarts=2), (7, 4)),
    "pgd_targeted": (dict(attack_method="PGD", num_steps=1, targeted=True), (3, 1)),
    "fgsm": (dict(attack_method="FGSM"), (3, 1)),
    "cw": (dict(attack_method="CW", cw_iters=2), (5, 2)),
    "pre_square": (dict(attack_method="PGD", num_steps=1, pre_square=True), (3, 1)),
    "none": (dict(attack_method="none"), (1, 0)),
}


def _eval_model(dev, model_sd, source):
    from edge_enhancement_tpu_torch.models.registry import build_model
    model = build_model("resnet18_EE_square", EVAL_EE, 200, square_source=source)
    model.load_state_dict(model_sd)
    return model.to(dev)


def _eval_run(dev, fields, model_sd, x, y, draws, start, offset, replace=None):
    """One eval step on `dev`, the draws taken in turn by pre_square and
    the forwards; returns (metrics, each attack call's x_adv). With
    `replace`, attack call i returns replace[i] in place of its x_adv."""
    from edge_enhancement_tpu_torch.attacks import cw as tcw
    from edge_enhancement_tpu_torch.attacks import pgd as tpgd
    from edge_enhancement_tpu_torch.train import trainer as T
    from edge_enhancement_tpu_torch.train.modelops import ModelOps

    seq = iter(draws)
    source = lambda shape: tuple(t.to(dev) for t in next(seq))
    model = _eval_model(dev, model_sd, source)
    captured = []

    def spy(fn, pair):
        def run(*a, **k):
            out = fn(*a, **k)
            captured.append((out[0] if pair else out).cpu())
            if replace is None:
                return out
            r = replace[len(captured) - 1].to(dev)
            return (r, out[1]) if pair else r
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpgd, "uniform_init_noise", lambda xx, e, g: start.to(dev))
        mp.setattr(tcw, "uniform_start", lambda xx, m, g: start.to(dev))
        real = T.random_targets
        mp.setattr(T, "random_targets",
                   lambda lab, n, g: real(lab, n, offset=offset.to(dev)))
        for name, pair in (("pgd_linf", False), ("fgsm", False), ("cw_linf", True)):
            mp.setattr(T, name, spy(getattr(T, name), pair))
        step = T.build_eval_step(ModelOps(model), T.EvalAttackConfig(
            epsilon=EPS, step_size=2 / 255, num_classes=200, square_epsilon=EPS,
            **fields), square_source=source)
        m = step(T.create_train_state(model), x.to(dev), y.to(dev))
    return {k: float(v) for k, v in m.items()}, captured


@pytest.mark.parametrize("branch", list(EVAL_BRANCHES))
def test_eval_battery_on_the_card_matches_the_cpu(cuda, branch, monkeypatch):
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.ops.square import add_square
    fields, (n_fwd, n_bwd) = EVAL_BRANCHES[branch]
    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet18_EE_square", EVAL_EE, 200, generator=gen)
    model_sd = model.state_dict()
    x = torch.rand(EVAL_SHAPE, generator=gen)
    draws = [add_square_draws(EVAL_SHAPE, gen) for _ in range(n_fwd + 1)]
    start = torch.rand(EVAL_SHAPE, generator=gen) * (2 * EPS) - EPS
    offset = torch.randint(1, 200, (EVAL_SHAPE[0],), generator=gen)
    # the labels: the CPU model's clean predictions, so every sample starts
    # correct (the pre-square draw first, then the clean forward's)
    pre = bool(fields.get("pre_square"))
    xc = add_square(x, draws[0], epsilon=EPS) if pre else x
    model.square_source = lambda shape: draws[int(pre)]
    with torch.no_grad():
        y = model.eval()(xc).argmax(-1)
    m_cpu, cap_cpu = _eval_run("cpu", fields, model_sd, x, y, draws, start, offset)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    F.reset_launches()
    m_gpu, cap_gpu = _eval_run(cuda, fields, model_sd, x, y, draws, start, offset,
                               replace=cap_cpu)
    torch.cuda.synchronize()
    assert F.LAUNCHES == {"ee_fused_fwd": n_fwd, "ee_fused_bwd": n_bwd,
                          "ee_fused_fwd_bf16": 0, "ee_fused_bwd_bf16": 0,
                          "canny_fused_fwd": 0, "canny_fused_bwd": 0,
                          "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}
    assert m_gpu["clean_top1"] == m_cpu["clean_top1"] == 100.0
    np.testing.assert_allclose(m_gpu["clean_loss"], m_cpu["clean_loss"], rtol=1e-4)
    assert len(cap_gpu) == len(cap_cpu) == (0 if branch == "none"
                                            else fields.get("restarts", 1))
    for got, want in zip(cap_gpu, cap_cpu):
        share = ((got - want).abs() > 1e-6).float().mean().item()
        assert share <= EVAL_XADV_SHARE, share
    if branch != "none":
        assert m_gpu["adv_top1"] == m_cpu["adv_top1"]
        np.testing.assert_allclose(m_gpu["adv_loss"], m_cpu["adv_loss"], rtol=1e-4)


def _chained_flagship(dev, chained: bool, steps: int = 3):
    """`steps` flagship train steps (resnet18_EE_square, 10 classes, PGD-2)
    at 8 x 32 x 32 on the card, from one seed: eager, or one chained
    dispatch (train/graphs.py: step 1 eager, the capture, the rest
    replayed). Returns the state's tensors, the last loss and the step."""
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.objectives.methods import MethodConfig
    from edge_enhancement_tpu_torch.train import trainer
    from edge_enhancement_tpu_torch.train.modelops import ModelOps

    gen = torch.Generator(device=dev).manual_seed(3)
    args = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
                type_canny="CannyFilter_step125_1", epsilon=EPS, n_queries=1)
    model = build_model("resnet18_EE_square", args, 10,
                        square_source=lambda shape: add_square_draws(shape, gen),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    data = torch.Generator().manual_seed(1)
    xs = torch.randint(0, 256, (steps, 8, 32, 32, 3), generator=data,
                       dtype=torch.uint8).to(dev)
    ys = torch.randint(0, 10, (steps, 8), generator=data).to(dev)
    method = MethodConfig("EE_BPDA3_AT_square", epsilon=EPS, num_steps=2,
                          step_size=2 / 255, num_classes=10)
    args = (ModelOps(model), method, trainer.OptimConfig(0.9, 2e-4), gen)
    state = trainer.create_train_state(model)
    if chained:
        step = trainer.build_chained_train_step(*args)
        m = step(state, xs, ys, 0.1)
        assert step.capture_seconds is not None
    else:
        step = trainer.build_train_step(*args)
        for x, y in zip(xs, ys):
            m = step(state, x, y, 0.1)
    return [*model.state_dict().values(), *state.momentum_buf], m["loss"], state.step


def test_chained_graph_replays_the_eager_steps_bit_for_bit(cuda):
    """chip_smoke.py's q2 at a small size: one chained dispatch of 3 steps
    (eager, capture, 2 replays) against 3 eager steps from one seed,
    cuDNN deterministic and TF32 off: parameters, BatchNorm statistics,
    momentum and the last loss equal bit for bit, after two eager runs
    were found equal; the K1/K2 launch counts of the replays counted."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eager, loss, n = _chained_flagship(cuda, False)
        again, loss2, _ = _chained_flagship(cuda, False)
        F.reset_launches()
        graphed, loss3, n3 = _chained_flagship(cuda, True)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved
    assert all(torch.equal(a, b) for a, b in zip(eager, again)) and torch.equal(loss, loss2)
    assert n == n3 == 3
    assert all(torch.equal(a, b) for a, b in zip(eager, graphed)) and torch.equal(loss, loss3)
    # 3 steps of PGD-2: K1 3 a step, K2 2 a step, the capture's not counted
    assert launches["ee_fused_fwd"] == 9 and launches["ee_fused_bwd"] == 6


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (2, 3, 15, 15), (8, 64, 112, 112)])
def test_max_pool_tie_routing_matches_the_cpu(cuda, shape):
    """The card's max pool (ops/pooling.py: F.max_pool2d) on plateaus
    against the CPU's, which tests/test_torch_ops.py pins to the JAX
    package's first-max routing: the same outputs, and with integer
    cotangents (overlapping windows sum exactly in any order) the same
    input gradient, exactly. The last shape is ImageNet's stem output."""
    from edge_enhancement_tpu_torch.ops import pooling

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.integers(0, 4, size=shape) / 3.0).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_()
        y = pooling.max_pool_3x3_s2(xd)
        if not grads:
            g = torch.from_numpy(rng.integers(-4, 5, size=tuple(y.shape)).astype(np.float32))
        y.backward(g.to(dev))
        grads.append((y.detach().cpu(), xd.grad.cpu()))
    (y_cpu, dx_cpu), (y_card, dx_card) = grads
    assert torch.equal(y_card, y_cpu)
    assert torch.equal(dx_card, dx_cpu), (dx_card != dx_cpu).sum().item()


# the flagship's layers (ResNet-18 at 64 px, batch 100): the stem's 7x7 /2
# convolution, a layer1 3x3 convolution, the stem's BatchNorm in train mode
GRAD_LAYERS = {"stem_conv": (100, 3, 64, 64), "layer1_conv": (100, 64, 16, 16),
               "stem_batchnorm": (100, 64, 32, 32)}
# ||dx(card) - dx(CPU)|| / ||dx(CPU)||: float32 sums of <= 3,136 terms in
# another order (~1e-7 each), float64 the same at 2^-53
GRAD_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layer", list(GRAD_LAYERS))
def test_layer_input_gradient_on_the_card_matches_the_cpu(cuda, layer, dtype):
    """The card's input gradient of one cuDNN convolution (dgrad) and of one
    train-mode BatchNorm (models/batchnorm.py) against the CPU's on the
    same weights, input and cotangent, TF32 off: whether either layer alone
    is where the whole model's card-vs-CPU input gradient parts (~1e-2 of
    its norm in chip_smoke.py's j2). Prints the relative gap."""
    from edge_enhancement_tpu_torch.models import resnet
    from edge_enhancement_tpu_torch.models.batchnorm import BatchNorm2d

    shape = GRAD_LAYERS[layer]
    gen = torch.Generator().manual_seed(0)
    if layer == "stem_conv":
        module = resnet.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
    elif layer == "layer1_conv":
        module = resnet._conv(64, 64, 3)
    else:
        module = BatchNorm2d(64)
        with torch.no_grad():
            module.weight.copy_(torch.rand(64, generator=gen) + 0.5)
            module.bias.copy_(torch.randn(64, generator=gen))
    module = module.to(dtype)
    x = torch.randn(shape, generator=gen, dtype=dtype)
    with torch.no_grad():
        u = torch.randn_like(module(x))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = {}
        for dev in ("cpu", cuda):
            m = module.to(dev)
            xd = x.to(dev).requires_grad_()
            out = m(xd)
            (dx,) = torch.autograd.grad(out, xd, u.to(dev))
            got[str(dev)] = (out.detach().cpu(), dx.cpu())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (out_cpu, dx_cpu), (out_card, dx_card) = got["cpu"], got[str(cuda)]
    rel = ((dx_card - dx_cpu).norm() / dx_cpu.norm()).item()
    rel_out = ((out_card - out_cpu).norm() / out_cpu.norm()).item()
    print(f"[grad card vs cpu] {layer} {dtype}: dx {rel:.3e} of its norm, "
          f"max {(dx_card - dx_cpu).abs().max().item():.3e}; forward {rel_out:.3e}")
    assert rel_out <= GRAD_TOL[dtype], rel_out
    assert rel <= GRAD_TOL[dtype], rel
