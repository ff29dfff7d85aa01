"""The fused front-end module of the port (ops/cuda/ee_fused.py): its plain
forward and explicit adjoint against the JAX `_ee_fused` pair (Pallas in
interpret mode), the adjoint against torch autograd of the plain forward,
and the port's front-end against the JAX unfused `ee_frontend`. The same
numpy inputs and square draws go to both sides."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.ops.pallas import ee_fused as jfused
from edge_enhancement_tpu.ops.square import add_square_draws
from edge_enhancement_tpu_torch.models import ee_frontend as tee
from edge_enhancement_tpu_torch.ops import square as tsq
from edge_enhancement_tpu_torch.ops.cuda import ee_fused as tfused

EPS = 0.062745098039216
B, H, W, C = 2, 32, 32, 3


def _inputs(seed, h=H, w=W):
    """x with a constant patch (|g| = 0 there) and exact 0 / 1 pixels."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, h, w, C)).astype(np.float32)
    x[:, 4:12, 4:12, :] = 0.5
    x[0, 20:28, 2:10, :] = 1.0
    x[1, 0:6, 20:30, :] = 0.0
    u = rng.standard_normal((B, h, w, C)).astype(np.float32)
    return x, u


def _draws(square, h=H, w=W):
    """Kernel-layout draws: stripes (B, C, 1, W), sq_delta (1, C, H, W)."""
    if not square:
        return None, None
    stripes4, mask, sign = (np.asarray(d) for d in add_square_draws(
        jax.random.PRNGKey(7), (B, h, w, C), epsilon=EPS))
    st = np.ascontiguousarray(stripes4.transpose(0, 3, 1, 2))
    sqd = np.ascontiguousarray(
        (2.0 * EPS * sign.transpose(0, 3, 1, 2) * mask[None, None]).astype(np.float32))
    return st, sqd


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax_args(square):
    return (8, EPS, 1.0, 0.0, 76 / 255, 1.0, 8, square)


def _consts(square):
    return tfused.FusedConsts(r=8, eps=EPS, w=1.0, alpha=0.0, high=76 / 255,
                              sigma=1.0, square=square)


def _jax_operands(square, st, sqd, h=H, w=W):
    if square:
        return jnp.asarray(st), jnp.asarray(sqd)
    return jnp.zeros((1, 1, 1, 1)), jnp.zeros((1, C, h, w))


@pytest.mark.parametrize("square", [True, False])
def test_plain_forward_matches_jax_kernel(square):
    x, _ = _inputs(0)
    st, sqd = _draws(square)
    out_j, (_, _, _, y_j) = jfused._ee_fused_fwd_impl(
        jnp.asarray(x), *_jax_operands(square, st, sqd), *_jax_args(square))
    t = lambda a: None if a is None else torch.from_numpy(a)
    out, y = tfused.ee_fused_fwd_plain(_nchw(x), t(st), t(sqd), _consts(square))
    # the edge maps agree exactly (y jumps by w = 1 where one flips); the HFS
    # products differ by summation order only: 1e-6 on values of order 1
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j).transpose(0, 3, 1, 2),
                               atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-6)


@pytest.mark.parametrize("square", [True, False])
def test_adjoint_matches_jax_grad_and_autograd(square):
    x, u = _inputs(1)
    st, sqd = _draws(square)
    g_j = jax.grad(lambda v: jnp.sum(jfused._ee_fused(
        v, *_jax_operands(square, st, sqd), *_jax_args(square)) * u))(jnp.asarray(x))
    g_j = np.asarray(g_j).transpose(0, 3, 1, 2)
    t = lambda a: None if a is None else torch.from_numpy(a)
    k = _consts(square)
    xt, ut = _nchw(x), _nchw(u)
    _, y = tfused.ee_fused_fwd_plain(xt, t(st), t(sqd), k)
    explicit = tfused.ee_fused_bwd_plain(ut, xt, t(st), t(sqd), y, k).numpy()
    xa = xt.clone().requires_grad_()
    out, _ = tfused.ee_fused_fwd_plain(xa, t(st), t(sqd), k)
    (auto,) = torch.autograd.grad((out * ut).sum(), [xa])
    # the same masks on both sides (ties at 0/1 are structural here); the
    # remaining differences are float32 summation order: |dx| <= ~3
    assert np.abs(g_j).max() > 0.1
    np.testing.assert_allclose(explicit, g_j, atol=1e-5)
    np.testing.assert_allclose(auto.numpy(), g_j, atol=1e-5)
    # and through the autograd.Function the model uses (CPU: plain versions)
    xf = xt.clone().requires_grad_()
    (g_fn,) = torch.autograd.grad(
        (tfused.ee_fused(xf, t(st), t(sqd), k) * ut).sum(), [xf])
    np.testing.assert_array_equal(g_fn.numpy(), explicit)


# 30 x 30: a size that is not a multiple of 4 or of the CUDA kernels' band
# rows, the oracle the card compares K1/K2 with there
RAGGED = 30


@pytest.mark.parametrize("square", [True, False])
def test_plain_pair_matches_jax_kernel_at_a_ragged_size(square):
    n = RAGGED
    x, u = _inputs(3, n, n)
    x[1, 11:19, 25:30, :] = 1.0                  # saturated at the ragged edge
    st, sqd = _draws(square, n, n)
    ops = _jax_operands(square, st, sqd, n, n)
    out_j, (_, _, _, y_j) = jfused._ee_fused_fwd_impl(jnp.asarray(x), *ops,
                                                      *_jax_args(square))
    g_j = jax.grad(lambda v: jnp.sum(jfused._ee_fused(v, *ops, *_jax_args(square)) * u))(
        jnp.asarray(x))
    t = lambda a: None if a is None else torch.from_numpy(a)
    k = _consts(square)
    xt, ut = _nchw(x), _nchw(u)
    out, y = tfused.ee_fused_fwd_plain(xt, t(st), t(sqd), k)
    # as at 32 x 32: exact edge maps, HFS products in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j).transpose(0, 3, 1, 2),
                               atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-6)
    dx = tfused.ee_fused_bwd_plain(ut, xt, t(st), t(sqd), y, k).numpy()
    g_j = np.asarray(g_j).transpose(0, 3, 1, 2)
    assert np.abs(g_j).max() > 0.1
    np.testing.assert_allclose(dx, g_j, atol=1e-5)


@pytest.mark.parametrize("square", [True, False])
def test_frontend_matches_jax_unfused(square):
    x, u = _inputs(2)
    key = jax.random.PRNGKey(3)
    base = dict(r=8, w=1.0, low=38., high=76., alpha=0.0, sigma=1.0,
                type_canny="CannyFilter_step125_1", square=square,
                epsilon=EPS, n_queries=1)
    fn = lambda v: jee.ee_frontend(v, jee.EEConfig(**base, fused=False),
                                   key if square else None)
    out_j, vjp = jax.vjp(fn, jnp.asarray(x))
    g_j = np.asarray(vjp(jnp.asarray(u))[0])
    # the draws the JAX add_square makes from `key`, as the port's source
    draws = [torch.from_numpy(np.array(d)) for d in add_square_draws(
        key, x.shape, epsilon=EPS)]
    xt = torch.from_numpy(x).requires_grad_()
    out = tee.ee_frontend(xt, tee.EEConfig(**base), lambda shape: draws)
    out.backward(torch.from_numpy(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, atol=1e-5)


def test_unported_variants_raise():
    """What the front-end refuses: a variant it does not know. (The full
    and BPDA Canny and the U2-NetP edge map run under the bf16 policy:
    tests/test_torch_frontend_variants.py holds them to JAX.)"""
    x = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tee.ee_frontend(torch.zeros(1, 8, 8, 3), tee.EEConfig(type_canny="Sobel"))
    out = tee.ee_frontend(x, tee.EEConfig(type_canny="CannyFilter_step125_1", square=True,
                                          n_queries=5),
                          lambda shape, **kw: tsq.add_square_draws(
                              shape, torch.Generator().manual_seed(0), **kw))
    assert out.dtype == torch.bfloat16


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises: never the plain
    version."""
    x = torch.zeros(1, 3, 8, 8, device="meta")
    tfused.reset_launches()
    with pytest.raises(ValueError):
        tfused.ee_fused_fwd(x, None, None, _consts(False))
    assert tfused.LAUNCHES["ee_fused_fwd"] == tfused.LAUNCHES["ee_fused_bwd"] == 0
