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


@pytest.mark.parametrize("cin", [5, 13, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_channels_leaves_the_plain_result_bit_for_bit(cin, dtype):
    """The bf16 kernel's channel padding to a multiple of 8 adds zero
    products only: the plain result is unchanged to the bit."""
    x, wk = _operands((2, 7, 9, cin, 16), 4)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(wk).to(dtype)
    xp, wp = tgc.pad_channels(xt, wt)
    assert xp.shape[-1] % 8 == 0 and xp.shape[-1] - cin < 8
    assert wp.shape == (3, 3, xp.shape[-1], 16)
    if cin % 8 == 0:
        assert xp is xt and wp is wt
    got = tgc.conv_cgemm_nhwc(xp, wp)
    want = tgc.conv_cgemm_nhwc(xt, wt)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_padded_packed_layout_is_jax_pack_weights_rearranged():
    """What the bf16 kernel reads for C_in = 5: the (C_out, 9 * 8) tap-major
    packing of the padded weights, whose first 5 channels of each tap are
    JAX's pack_weights and the rest zero."""
    _, wk = _operands((1, 4, 4, 5, 7), 5)
    _, wp = tgc.pad_channels(torch.zeros(1, 4, 4, 5), torch.from_numpy(wk))
    packed = tgc.pack_weights(wp).numpy().reshape(7, 9, 8)
    want = np.asarray(jgc.pack_weights(jnp.asarray(wk))).reshape(7, 9, 5)
    np.testing.assert_array_equal(packed[:, :, :5], want)
    assert not packed[:, :, 5:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_entry_matches_the_op_and_jax(dtype):
    """conv_cgemm_packed (weights packed once) is the op bit for bit on the
    CPU, and the JAX conv within the op's tolerance."""
    x, wk = _operands((2, 8, 8, 16, 24), 6)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(wk).to(dtype)
    got = tgc.conv_cgemm_packed(xt, tgc.pack_weights(wt).contiguous())
    assert torch.equal(got, tgc.conv_cgemm_nhwc(xt, wt))
    if dtype == torch.float32:
        want = np.asarray(jgc.conv_cgemm_nhwc(jnp.asarray(x), jnp.asarray(wk)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
