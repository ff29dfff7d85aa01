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
