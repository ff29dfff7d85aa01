"""The Canny-only pair of the port (ops/cuda/ee_fused.py: canny_fused_fwd /
canny_fused_bwd, K3a/K3b; plain versions on the CPU) against the JAX
`canny_step125_fused` pair (Pallas in interpret mode), the front-end with
the smoothed edge map (`with_gf`) against the JAX front-end, and one train
step of the flagship recipe with `gf: true` against one JAX step. The same
numpy inputs and square draws go to both sides."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import importlib

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

jcanny = importlib.import_module("edge_enhancement_tpu.ops.canny")

HIGH = 76 / 255
CASES = [((4, 20, 24, 3), 0.1), ((2, 28, 28, 1), 0.3)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _image(shape, seed):
    """Uniform pixels with a constant patch (|g| = 0 there) and a saturated
    block, so every branch of the magnitude and the threshold is taken."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x[:, 2:8, 3:9, :] = 0.5
    x[0, 10:18, 12:20, :] = 1.0
    return x


@pytest.mark.parametrize("shape,alpha", CASES)
def test_plain_forward_matches_jax_kernel(shape, alpha):
    x = _image(shape, 0)
    out_j, mag_j, gx_j, gy_j = jfused._canny_fused_fwd_impl(
        jnp.asarray(x), HIGH, 1.0, alpha, 8)
    out, mag, gx, gy = tfused.canny_fused_fwd(_nchw(x), HIGH, 1.0, alpha)
    assert out.shape == (shape[0], 1) + shape[1:3]
    assert 0.0 < float(out.mean()) < 1.0
    # the edge maps agree exactly
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(out_j))
    # the residuals: interpret mode compiles the kernel body with XLA, whose
    # fused CPU loops round the stencil sums otherwise (measured <= 2 ulp,
    # 3.3e-7); JAX's op-by-op composition gives the port's gx, gy exactly
    for got, want in ((mag, mag_j), (gx, gx_j), (gy, gy_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    _, gx_e, gy_e, _ = jcanny._blur_sobel_magnitude(jnp.asarray(x), 1.0)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(gx_e).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(gy_e).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("shape,alpha", CASES)
def test_adjoint_matches_jax_grad_and_autograd(shape, alpha):
    x = _image(shape, 1)
    b, h, w, c = shape
    u = np.random.default_rng(2).standard_normal((b, h, w, 1)).astype(np.float32)
    high = 0.2
    g_j = jax.grad(lambda v: jnp.sum(jfused.canny_step125_fused(
        v, high, 1.0, alpha) * u))(jnp.asarray(x))
    g_j = np.asarray(g_j).transpose(0, 3, 1, 2)
    xt, ut = _nchw(x), _nchw(u)
    _, mag, gx, gy = tfused.canny_fused_fwd_plain(xt, high, 1.0, alpha)
    explicit = tfused.canny_fused_bwd(ut, mag, gx, gy, c, high, 1.0, alpha)
    xa = xt.clone().requires_grad_()
    (auto,) = torch.autograd.grad(
        (tfused.canny_fused_fwd_plain(xa, high, 1.0, alpha)[0] * ut).sum(), [xa])
    # the same masks on both sides; float32 summation order and 1/|g| of
    # residuals that differ by an ulp (|dx| up to ~30)
    assert np.abs(g_j).max() > 0.1
    np.testing.assert_allclose(explicit.numpy(), g_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(auto.numpy(), g_j, rtol=1e-4, atol=1e-4)
    # the NHWC entry point through the autograd.Function (CPU: plain versions)
    xf = torch.from_numpy(x).requires_grad_()
    (g_fn,) = torch.autograd.grad(
        (tfused.canny_step125_fused(xf, high, 1.0, alpha) * torch.from_numpy(u)).sum(),
        [xf])
    np.testing.assert_array_equal(g_fn.permute(0, 3, 1, 2).numpy(), explicit.numpy())


@pytest.mark.parametrize("square", [True, False])
def test_gf_frontend_matches_jax(square):
    shape = (2, 32, 32, 3)
    x = _image(shape, 3)
    u = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    base = dict(r=8, w=1.0, low=38., high=76., alpha=0.0, sigma=1.0,
                type_canny="CannyFilter_step125_1", with_gf=True,
                square=square, epsilon=helpers.EPS, n_queries=1)
    fn = lambda v: jee.ee_frontend(v, jee.EEConfig(**base, fused=True),
                                   key if square else None)
    out_j, vjp = jax.vjp(fn, jnp.asarray(x))
    g_j = np.asarray(vjp(jnp.asarray(u))[0])
    draws = [torch.from_numpy(np.array(d)) for d in add_square_draws(
        key, shape, epsilon=helpers.EPS)]
    xt = torch.from_numpy(x).requires_grad_()
    tfused.reset_launches()
    out = tee.ee_frontend(xt, tee.EEConfig(**base), lambda s: draws)
    out.backward(torch.from_numpy(u))
    # the HFS products differ by summation order only: 1e-6 on values of
    # order 1; the edge maps agree exactly
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-6)
    assert np.abs(g_j).max() > 0.1
    np.testing.assert_allclose(xt.grad.numpy(), g_j, atol=1e-5)
    # on the CPU no kernel launches
    assert all(v == 0 for v in tfused.LAUNCHES.values())


def test_gf_train_step_matches_jax(monkeypatch):
    """One EE_BPDA3_AT_square step with `gf: true`, on carried weights and
    replayed draws, as tests/test_torch_train_step.py does without it."""
    port, jax_side = helpers.train_step_pair(
        monkeypatch, ee_args=dict(helpers.EE_ARGS, gf=True))
    assert port[2].ee.with_gf
    helpers.assert_train_steps_agree(port, jax_side)


# ---- the rounding premise of the bfloat16 K3a/K3b --------------------------
# The plain bfloat16 version computes each step in float32 and rounds the
# result to bfloat16; the kernels round once, in packed bf16x2 instructions
# (products and sums) or by one conversion of a float32 IEEE result (the
# division by C, the square root). Both give the same bits because a float32
# operation on bfloat16 operands, rounded to bfloat16, is one correct
# rounding of the exact result (24 >= 2 x 8 + 2 significand bits). Checked on
# every finite bfloat16 against 40 operands (or every C up to the kernels'
# 66 channels): the exact result computed in float64 and rounded in numpy,
# or bracketed between the neighbouring rounding boundaries by comparisons
# that float64 makes exactly.

def _finite_bf16():
    """Every finite bfloat16 value, as float64."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = bits.double().numpy()
    return v[np.isfinite(v)]


def _ulp_above(r):
    """The bfloat16 spacing above |r| (2^-133 below the normal range)."""
    _, e = np.frexp(np.abs(r))
    return np.ldexp(1.0, np.maximum(e, -125) - 8)


def _rne_bf16(v, sticky=None):
    """v (float64) rounded to the nearest bfloat16, ties to even, without
    passing through float32; `sticky`'s sign says on which side of v the
    exact value lies where v itself is not exact."""
    q = _ulp_above(v)
    t = v / q                                    # exact: a power of two
    r = np.round(t)                              # ties to even
    if sticky is not None:
        tie = t - np.floor(t) == 0.5
        r = np.where(tie & (sticky > 0), np.floor(t) + 1, r)
        r = np.where(tie & (sticky < 0), np.floor(t), r)
    out = r * q
    return np.where(np.abs(out) >= 2.0 ** 128, np.copysign(np.inf, v), out)


def _via_float32(f32):
    """A float32 result rounded to bfloat16 as the plain version rounds it."""
    return torch.from_numpy(np.ascontiguousarray(f32)).to(torch.bfloat16).double().numpy()


def _bracketed(r, compare):
    """Whether r (bfloat16 values >= 0) is the nearest-even rounding of the
    exact x >= 0 that compare(m) sets against each boundary m (sign of
    x - m, computed exactly)."""
    q_hi = _ulp_above(r)
    m, e = np.frexp(r)
    q_lo = np.where((m == 0.5) & (e >= -124), q_hi / 2, q_hi)
    even = (torch.from_numpy(r).to(torch.bfloat16).view(torch.int16).numpy() & 1) == 0
    below = np.where(r == 0, 1, compare(r - q_lo / 2))   # x >= 0: nothing rounds below 0
    above = compare(r + q_hi / 2)
    return ((below > 0) | ((below == 0) & even)) & ((above < 0) | ((above == 0) & even))


def _operands():
    """40 bfloat16 operands: the Sobel's and the Gaussian's taps, signs,
    the subnormal and normal extremes, and random bit patterns."""
    rng = np.random.default_rng(7)
    taps = [float(t) for t in tfused.gaussian_taps(1.0, "cpu", torch.bfloat16)[:2]]
    special = [1.0, -1.0, 0.5, -0.5, 2.0 ** -133, 2.0 ** -126, -3.3895313892515355e38] + taps
    bits = rng.integers(0, 1 << 16, 64).astype(np.int16)
    rand = torch.from_numpy(bits).view(torch.bfloat16).double().numpy()
    rand = rand[np.isfinite(rand)][:40 - len(special)]
    return np.concatenate([special, rand])


@pytest.mark.parametrize("op", ["mul", "add", "div", "sqrt"])
def test_bfloat16_steps_round_once(op):
    """A float32 x, +, / C or sqrt of bfloat16 operands, rounded to
    bfloat16, is the exact result rounded once to nearest-even."""
    a = _finite_bf16()
    a32 = a.astype(np.float32)                   # exact: bfloat16 values
    checked = 0
    with np.errstate(over="ignore", invalid="ignore"):
        if op in ("mul", "add"):
            for b in _operands():
                got = _via_float32(a32 * np.float32(b) if op == "mul" else a32 + np.float32(b))
                if op == "mul":
                    want = _rne_bf16(a * b)      # exact: 16 significand bits
                else:
                    s = a + b                    # TwoSum: s + err is exact
                    bb = s - a
                    want = _rne_bf16(s, (a - (s - bb)) + (b - bb))
                np.testing.assert_array_equal(got, want)
                assert np.array_equal(np.signbit(got), np.signbit(want))
                checked += a.size
        elif op == "div":
            for c in range(1, 67):
                got = np.abs(_via_float32(a32 / np.float32(c)))
                assert _bracketed(got, lambda m: np.sign(np.abs(a) - c * m)).all(), c
                checked += a.size
        else:
            x = a[a >= 0]
            got = _via_float32(np.sqrt(x.astype(np.float32)))
            assert _bracketed(got, lambda m: np.sign(x - m * m)).all()
            checked += x.size
    assert checked >= 32000
