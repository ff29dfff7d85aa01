"""The fused front-end module of the port in bfloat16 (the bf16 policy of
the fast-AT recipes): its plain forward and adjoint against the JAX
`_ee_fused` pair at bfloat16 (Pallas in interpret mode), and the port's
front-end against the JAX `ee_frontend` at bfloat16, fused and unfused.

JAX rounds every bfloat16 operation (each product and sum of the blur, the
Sobel and the square chain; jnp sums a low-precision array in float32 and
rounds once). XLA's CPU compiler, left to itself, drops the rounding of a
bfloat16 value that feeds an explicit float32 upcast (the blur's last sum
before the channel sum: 18% of the summed blur then differs, and 0.3% of
the edge map); so the JAX side is compiled with
xla_allow_excess_precision off, which keeps every rounding the program
asks for. Draws are made on the JAX side and passed in."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.ops.pallas import ee_fused as jfused
from edge_enhancement_tpu.ops.square import add_square_draws
from edge_enhancement_tpu_torch.models import ee_frontend as tee
from edge_enhancement_tpu_torch.ops.cuda import ee_fused as tfused

EPS = 0.062745098039216
B, H, W, C = 2, 32, 32, 3
BF = jnp.bfloat16
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
# dx: JAX and the port sum the float32 parts of dx = dx_hfs + dx_canny in
# other orders, which moves the last bits of values near zero: at most
# DX_SHARE of dx more than one bf16 ulp off (measured 0.05%), and those
# values are tiny (measured |err| 2.2e-9).
DX_SHARE, DX_TINY = 1e-3, 1e-6


def _inputs(seed):
    """x with a constant patch (|g| = 0 there) and exact 0 / 1 pixels, as
    tests/test_torch_ee_fused.py."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, H, W, C)).astype(np.float32)
    x[:, 4:12, 4:12, :] = 0.5
    x[0, 20:28, 2:10, :] = 1.0
    x[1, 0:6, 20:30, :] = 0.0
    u = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, u


def _draws(square):
    """Kernel-layout draws in float32 (the callers cast them to bfloat16)."""
    if not square:
        return None, None
    stripes4, mask, sign = (np.asarray(d) for d in add_square_draws(
        jax.random.PRNGKey(7), (B, H, W, C), epsilon=EPS))
    st = np.ascontiguousarray(stripes4.transpose(0, 3, 1, 2))
    sqd = np.ascontiguousarray(
        (2.0 * EPS * sign.transpose(0, 3, 1, 2) * mask[None, None]).astype(np.float32))
    return st, sqd


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16(a, nchw=False):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if nchw else a))
    return t.to(torch.bfloat16)


def _assert_dx_close(got, want):
    """One bf16 ulp, but for DX_SHARE of tiny values (DX_TINY)."""
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(np.ascontiguousarray(want)).float()
    off = tfused.bf16_ulps(got, want) > 1
    assert off.float().mean() <= DX_SHARE, off.float().mean()
    assert torch.where(off, (got - want).abs(), 0.0).max() <= DX_TINY


@pytest.mark.parametrize("square", [True, False])
def test_plain_pair_matches_jax_kernel_in_bf16(square):
    x, u = _inputs(0 if square else 1)
    st, sqd = _draws(square)
    jargs = (8, EPS, 1.0, 0.0, 76 / 255, 1.0, 8, square)
    ops = ((jnp.asarray(st, BF), jnp.asarray(sqd, BF)) if square
           else (jnp.zeros((1, 1, 1, 1), BF), jnp.zeros((1, C, H, W), BF)))

    def pair(v, cot):
        out, (_, _, _, y) = jfused._ee_fused_fwd_impl(v, *ops, *jargs)
        _, vjp = jax.vjp(lambda a: jfused._ee_fused(a, *ops, *jargs), v)
        return out, y, vjp(cot)[0]

    out_j, y_j, g_j = jax.jit(pair, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u).astype(BF))
    k = tfused.FusedConsts(r=8, eps=EPS, w=1.0, alpha=0.0, high=76 / 255,
                           sigma=1.0, square=square)
    xt, ut = _bf16(x, True), _bf16(u, True)
    out, y = tfused.ee_fused_fwd_plain(xt, _bf16(st), _bf16(sqd), k)
    dx = tfused.ee_fused_bwd_plain(ut, xt, _bf16(st), _bf16(sqd), y, k)
    assert out.dtype == y.dtype == dx.dtype == torch.bfloat16
    y_j = torch.from_numpy(_f32(y_j))
    # the edge map exactly (a flip moves y by w = 1); out and y within one
    # ulp (measured: bit for bit)
    assert (y.float() - y_j).abs().max() < 0.5
    assert tfused.bf16_ulps(y, y_j).max() <= 1
    out_j = torch.from_numpy(_f32(out_j).transpose(0, 3, 1, 2).copy())
    assert tfused.bf16_ulps(out, out_j).max() <= 1
    assert dx.float().abs().max() > 0.1
    _assert_dx_close(dx, _f32(g_j).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("square", [True, False])
def test_bf16_frontend_matches_jax_fused_and_unfused(square):
    """The port's bf16 front-end is the JAX fused front-end (K1/K2's), out
    exact and dx as above. The JAX unfused front-end at bf16 runs its
    division by C and magnitude in bfloat16 too (ops/canny.py), where the
    fused kernel runs them in float32: its edge map differs from the fused
    one's at 0.49% of these pixels (measured), so it is held to a share."""
    x, u = _inputs(2)
    key = jax.random.PRNGKey(3)
    base = dict(r=8, w=1.0, low=38., high=76., alpha=0.0, sigma=1.0,
                type_canny="CannyFilter_step125_1", square=square,
                epsilon=EPS, n_queries=1)

    def both(v, cot):
        res = []
        for fused in (True, False):
            fn = lambda a: jee.ee_frontend(a, jee.EEConfig(**base, fused=fused),
                                           key if square else None)
            o, vjp = jax.vjp(fn, v)
            res += [o, vjp(cot)[0]]
        return res

    out_f, g_f, out_u, _ = jax.jit(both, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u).astype(BF))
    draws = [torch.from_numpy(np.array(d)) for d in add_square_draws(
        key, x.shape, epsilon=EPS)]
    xt = _bf16(x).requires_grad_()
    out = tee.ee_frontend(xt, tee.EEConfig(**base), lambda shape: draws)
    out.backward(_bf16(u))
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    assert tfused.bf16_ulps(out, torch.from_numpy(_f32(out_f))).max() <= 1
    _assert_dx_close(xt.grad, _f32(g_f))
    flips = (out.detach().float().numpy() - _f32(out_u)).__abs__() > 0.25
    assert 0 < flips.mean() <= 0.01


# the Canny-only pair at bfloat16: (seed, alpha, high) of each case; the
# plain pair equals JAX's interpret-mode kernel bit for bit in all four
# outputs and in dx (measured: no element off), so they are held exactly
K3_CASES = [(0, 0.0, 76 / 255), (1, 0.1, 76 / 255), (2, 0.0, 0.05), (3, 0.0, 0.3)]
# the K3 front-end's dx against JAX's: relative norm and largest error as a
# share of the largest |dx| (measured 3.2e-3 and 9.0e-3)
K3_DX_NORM, K3_DX_MAX = 1e-2, 2e-2


@pytest.mark.parametrize("seed,alpha,high", K3_CASES)
def test_canny_only_pair_plain_matches_jax_kernel_in_bf16(seed, alpha, high):
    """K3a/K3b's plain bfloat16 versions against `_canny_fwd_kernel` and
    `_canny_bwd_kernel` at bfloat16 (Pallas in interpret mode): every
    operation in bfloat16 but the channel sum, the division by C and the
    magnitude included (K1's keep them in float32), the thresholds and taps
    rounded to bfloat16."""
    x, _ = _inputs(seed)
    u = np.random.default_rng(seed + 10).standard_normal((B, H, W, 1)).astype(np.float32)

    def pair(v, cot):
        out, mag, gx, gy = jfused._canny_fused_fwd_impl(v, high, 1.0, alpha, 8)
        _, vjp = jax.vjp(lambda a: jfused.canny_step125_fused(a, high, 1.0, alpha), v)
        return out, mag, gx, gy, vjp(cot)[0]

    out_j, mag_j, gx_j, gy_j, dx_j = jax.jit(pair, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u).astype(BF))
    xt, ut = _bf16(x, True), _bf16(u, True)
    out, mag, gx, gy = tfused.canny_fused_fwd_plain(xt, high, 1.0, alpha)
    dx = tfused.canny_fused_bwd_plain(ut, mag, gx, gy, C, high, 1.0, alpha)
    assert all(t.dtype == torch.bfloat16 for t in (out, mag, gx, gy, dx))
    nchw = lambda a: torch.from_numpy(_f32(a).transpose(0, 3, 1, 2).copy())
    for got, want in ((out, nchw(out_j)), (mag, torch.from_numpy(_f32(mag_j))),
                      (gx, torch.from_numpy(_f32(gx_j))), (gy, torch.from_numpy(_f32(gy_j))),
                      (dx, nchw(dx_j))):
        torch.testing.assert_close(got.float(), want, atol=0, rtol=0)
    assert 0 < out.float().mean() < 1 and dx.float().abs().max() > 0.01


def test_canny_only_pair_differs_from_k1_casts_in_bf16():
    """The bfloat16 K3 rounds the division by C and the magnitude where
    K1's keeps them in float32: their magnitudes differ at bfloat16
    resolution."""
    x, _ = _inputs(0)
    xt = _bf16(x, True)
    _, mag3, _, _ = tfused.canny_fused_fwd_plain(xt, 76 / 255, 1.0, 0.0)
    _, _, mag1 = tfused._blur_sobel_magnitude_nchw(xt, 1.0)
    assert mag1.dtype == torch.float32 and mag3.dtype == torch.bfloat16
    assert torch.equal(mag3.float(), mag3.float().bfloat16().float())
    assert (mag1 != mag3.float()).float().mean() > 0.5
    # three more bfloat16 roundings (the quotient, the squares and sum, the
    # root): within 2% of K1's float32 magnitude
    assert ((mag1 - mag3.float()).abs() <= 0.02 * mag1 + 1e-6).all()


@pytest.mark.parametrize("branch", ["gf", "gf_square", "queries"])
def test_bf16_k3_frontend_matches_jax_fused(branch):
    """The port's bfloat16 front-end where its edge map runs on K3a/K3b
    (gf; more than one square query) against the JAX front-end with
    `fused` at bfloat16: out within one ulp, dx as above."""
    x, u = _inputs(4)
    key = jax.random.PRNGKey(6)
    n = 3 if branch == "queries" else 1
    square = branch != "gf"
    base = dict(r=8, w=1.0, low=38., high=76., alpha=0.0, sigma=1.0,
                type_canny="CannyFilter_step125_1", square=square, epsilon=EPS,
                n_queries=n, with_gf=branch.startswith("gf"))

    def fn(v, cot):
        o, vjp = jax.vjp(lambda a: jee.ee_frontend(a, jee.EEConfig(**base, fused=True),
                                                   key if square else None), v)
        return o, vjp(cot)[0]

    out_j, g_j = jax.jit(fn, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u).astype(BF))
    draws = helpers.jax_draws(key, x.shape, n) if square else None
    xt = _bf16(x).requires_grad_()
    out = tee.ee_frontend(xt, tee.EEConfig(**base), lambda shape, **_: draws)
    out.backward(_bf16(u))
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    assert tfused.bf16_ulps(out, torch.from_numpy(_f32(out_j))).max() <= 1
    # dx = the HFS adjoint + K3b's. K3b's is JAX's bit for bit (above); the
    # HFS adjoint here is torch autograd of hfs_nchw at bfloat16, whose
    # roundings fall elsewhere than those of JAX's transposed einsums:
    # measured 1.7-5.4% of dx more than one ulp off, at most 0.9% of the
    # largest |dx|, 0.32% in norm
    got, want = xt.grad.float(), torch.from_numpy(_f32(g_j))
    assert float((got - want).norm() / want.norm()) <= K3_DX_NORM
    assert float((got - want).abs().max()) <= K3_DX_MAX * float(want.abs().max())
