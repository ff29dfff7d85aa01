"""The port's GEMM-conv (ops/cuda/gemm_conv.py, kernel K4; plain version on
the CPU) against the JAX `conv_cgemm_nhwc` / `conv3x3_cgemm` (Pallas in
interpret mode), on the shapes of tests/test_gemm_conv.py, and the plain
version against torch's own convolution."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.ops.pallas import gemm_conv as jgc
from edge_enhancement_tpu_torch.ops.cuda import gemm_conv as tgc

SHAPES = [(4, 16, 16, 64, 64), (2, 8, 8, 32, 64), (3, 16, 16, 64, 128),
          (2, 7, 9, 16, 32)]


def _operands(shape, seed):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    return x, wk


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape):
    x, wk = _operands(shape, 0)
    want = np.asarray(jgc.conv_cgemm_nhwc(jnp.asarray(x), jnp.asarray(wk)))
    got = tgc.conv_cgemm_nhwc(torch.from_numpy(x), torch.from_numpy(wk))
    assert got.shape == want.shape and got.dtype == torch.float32
    # 9 * C_in float32 products summed in another order: ~1e-6 on values ~3
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_grads_match_jax():
    x, wk = _operands((3, 16, 16, 64, 64), 1)
    loss_j = lambda v, w: jnp.sum(jnp.tanh(jgc.conv3x3_cgemm(v, w)))
    gx_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wk).requires_grad_()
    torch.tanh(tgc.conv3x3_cgemm(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=3e-4, rtol=1e-4)


def test_plain_matches_torch_conv_and_keeps_dtype():
    """The plain version against F.conv2d, in float32 and in bfloat16 (the
    bf16 plain version sums in float32 and rounds once at the end)."""
    x, wk = _operands((2, 7, 9, 16, 32), 2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wk)
    ref = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(tgc.conv_cgemm_nhwc(xt, wt), ref, atol=2e-5, rtol=1e-5)
    xb = xt.bfloat16()
    got = tgc.conv_cgemm_nhwc(xb, wt)
    assert got.dtype == torch.bfloat16
    ref_b = F.conv2d(xb.float().permute(0, 3, 1, 2),
                     wt.bfloat16().float().permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
    # one bf16 rounding of float32 sums that differ by ~1e-6: one bf16 ulp
    torch.testing.assert_close(got.float(), ref_b, atol=1e-3, rtol=2 ** -7)


def test_pack_and_dgrad_weights_match_jax():
    _, wk = _operands((1, 4, 4, 5, 7), 3)
    np.testing.assert_array_equal(tgc.pack_weights(torch.from_numpy(wk)).numpy(),
                                  np.asarray(jgc.pack_weights(jnp.asarray(wk))))
    np.testing.assert_array_equal(tgc._dgrad_weights(torch.from_numpy(wk)).numpy(),
                                  np.asarray(jgc._dgrad_weights(jnp.asarray(wk))))


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises: never the plain
    version."""
    tgc.reset_launches()
    with pytest.raises(ValueError):
        tgc.conv_cgemm_nhwc(torch.zeros(1, 4, 4, 8, device="meta"),
                            torch.zeros(3, 3, 8, 8, device="meta"))
    assert tgc.LAUNCHES == {"conv_cgemm_f32": 0, "conv_cgemm_bf16": 0}
