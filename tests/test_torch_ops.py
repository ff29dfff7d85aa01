"""The port's ops (edge_enhancement_tpu_torch/ops) against the JAX package's
on the same numpy inputs. Edge maps and stencils must agree bit for bit (the
hard threshold flips on one-ulp differences); matrix products and gradients
within the stated float32 tolerances."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.ops import filters as jfilters
from edge_enhancement_tpu.ops import hfs as jhfs
from edge_enhancement_tpu.ops import pooling as jpool
from edge_enhancement_tpu.ops import square as jsquare
from edge_enhancement_tpu.ops import stencil as jstencil
from edge_enhancement_tpu.ops import ste as jste
from edge_enhancement_tpu_torch.ops import canny, filters, hfs, pooling, square, stencil, ste

# the JAX ops package exports a function named `canny` over its submodule
jcanny = importlib.import_module("edge_enhancement_tpu.ops.canny")

# (shape, HFS radius): at 16x16, r=8 would make HFS the identity
SHAPES = [((2, 32, 32, 3), 8), ((2, 16, 16, 3), 4)]


def _image(shape, seed=0):
    """Uniform pixels with a constant patch (|g| = 0) and exact 0/1 pixels."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    h = shape[1]
    x[:, 2:h // 3, 2:h // 3, :] = 0.5
    x[0, h // 2:, : h // 4, :] = 1.0
    x[-1, h // 2:, h // 2:, :] = 0.0
    return x


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def test_filters_equal():
    np.testing.assert_array_equal(filters.gaussian_kernel(3, 0.0, 1.0),
                                  jfilters.gaussian_kernel(3, 0.0, 1.0))
    np.testing.assert_array_equal(filters.gaussian_kernel(3, 0.0, 0.7),
                                  jfilters.gaussian_kernel(3, 0.0, 0.7))
    np.testing.assert_array_equal(filters.sobel_kernel(3), jfilters.sobel_kernel(3))


@pytest.mark.parametrize("pad_mode", ["edge", "zero"])
def test_stencil_bit_exact(pad_mode):
    x = _image((2, 16, 16, 3))
    for kernel in (jfilters.gaussian_kernel(3, 0.0, 1.0), jfilters.sobel_kernel(3),
                   jfilters.sobel_kernel(3).T):
        np.testing.assert_array_equal(
            stencil.stencil2d(_t(x), kernel, pad_mode).numpy(),
            np.asarray(jstencil.stencil2d(jnp.asarray(x), kernel, pad_mode)))


def test_to_compare_masks():
    t = 76 / 255
    x = np.array([0.0, t, np.nextafter(np.float32(t), 1), 0.5, 1.0, 1.001,
                  1.0011, 2.0], np.float32)
    g = np.arange(1, x.size + 1, dtype=np.float32)
    xt = _t(x).requires_grad_()
    out = ste.to_compare(xt, t)
    out.backward(_t(g))
    out_j, vjp = jax.vjp(lambda v: jste.to_compare(v, t), jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("shape,alpha", [(SHAPES[0][0], 0.0), (SHAPES[1][0], 0.1)])
def test_canny_step125(shape, alpha):
    x = _image(shape, seed=1)
    u = np.random.default_rng(2).standard_normal(shape[:3] + (1,)).astype(np.float32)
    xt = _t(x).requires_grad_()
    out = canny.canny_step125(xt, high_threshold=76 / 255, alpha=alpha)
    out.backward(_t(u))
    fn = lambda v: jcanny.canny_step125(v, high_threshold=76 / 255, alpha=alpha)
    out_j, vjp = jax.vjp(fn, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    g_j = np.asarray(vjp(jnp.asarray(u))[0])
    assert np.isfinite(xt.grad.numpy()).all()          # zero |g| gives 0, not NaN
    # gradients: the same ops in the same order; 1e-6 covers sqrt/divide
    # rounding between the two libraries on values of order 1
    np.testing.assert_allclose(xt.grad.numpy(), g_j, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,r", SHAPES)
def test_hfs(shape, r):
    h, w = shape[1], shape[2]
    np.testing.assert_array_equal(hfs.hfs_mask(h, w, r), jhfs.hfs_mask(h, w, r))
    for a, b in zip(hfs._hfs_axis_operators(h, w, r), jhfs._hfs_axis_operators(h, w, r)):
        np.testing.assert_array_equal(a, b)
    x = _image(shape, seed=3)
    got = hfs.high_freq_suppress(_t(x), r).numpy()
    # two 32-term float32 products summed in another order: 1e-6 on values ~1
    np.testing.assert_allclose(
        got, np.asarray(jhfs.high_freq_suppress(jnp.asarray(x), r)), atol=2e-6)
    # torch.fft as the oracle of the operator factorisation
    mask = torch.from_numpy(hfs.hfs_mask(h, w, r))[None, :, :, None]
    xd = _t(x).double()
    fft = torch.fft.ifft2(torch.fft.fft2(xd, dim=(1, 2)) * mask, dim=(1, 2)).real
    np.testing.assert_allclose(got, fft.numpy(), atol=2e-6)


@pytest.mark.parametrize("shape", [s for s, _ in SHAPES])
def test_add_square_matches_jax(shape):
    eps = 0.062745098039216
    key = jax.random.PRNGKey(11)
    # the draws add_square makes from `key`, handed to the port
    draws = [_t(np.asarray(d)) for d in jsquare.add_square_draws(key, shape, epsilon=eps)]
    x = _image(shape, seed=4)
    u = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    xt = _t(x).requires_grad_()
    out = square.add_square(xt, draws, epsilon=eps)
    out.backward(_t(u))
    fn = lambda v: jsquare.add_square(v, key, epsilon=eps, n_queries=1)
    out_j, vjp = jax.vjp(fn, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    # clip and min/max ties split 0.5 on both sides: the masks are exact
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(u))[0]))


def test_square_draws_layout():
    b, h, w, c = 3, 64, 64, 3
    assert square.square_side(h, c) == 57
    for it in (0, 11, 60, 9000):
        assert square.p_selection(it, 0.8) == jsquare.p_selection(it, 0.8, 5000)
    gen = torch.Generator().manual_seed(0)
    stripes, mask, sign = square.add_square_draws((b, h, w, c), gen)
    assert stripes.shape == (b, 1, w, c) and sign.shape == (1, 1, 1, c)
    assert set(stripes.unique().tolist()) <= {-1.0, 1.0}
    assert set(sign.unique().tolist()) <= {-1.0, 1.0}
    rows = torch.nonzero(mask.any(dim=1)).flatten()
    vh = int(rows[0])
    assert len(rows) == 57 and 0 <= vh <= h - 57
    assert mask.sum() == 57 * 57 and mask[vh:vh + 57, vh:vh + 57].all()


def test_max_pool_tie_routing():
    """First-max tie routing, pinned against the JAX oracle on plateaus."""
    rng = np.random.default_rng(0)
    for h in (16, 15):
        x = (rng.integers(0, 4, size=(2, h, h, 3)) / 3.0).astype(np.float32)
        xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
        y = pooling.max_pool_3x3_s2(xt)
        # integer cotangents: overlapping windows sum exactly in any order
        g = rng.integers(-4, 5, size=y.shape).astype(np.float32)
        y.backward(_t(g))
        y_j, vjp = jax.vjp(jpool.max_pool_3x3_s2_firstmax, jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(),
                                      np.asarray(y_j).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(
            xt.grad.numpy(),
            np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))[0]).transpose(0, 3, 1, 2))
