"""The port's GEMM-conv (ops/cuda/gemm_conv.py, kernel K4; plain version on
the CPU) against the JAX `conv_cgemm_nhwc` / `conv3x3_cgemm` (Pallas in
interpret mode), on the shapes of tests/test_gemm_conv.py, and the plain
version against torch's own convolution. The float32 kernel computes three
TF32 products (3xTF32): `split_tf32` is held bit for bit against a numpy
rounding, and a CPU emulation of the three products against JAX."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
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
    """conv_cgemm_packed (weights packed once by pack_operands) is the op
    bit for bit on the CPU, on the weights the packing stands for (float32:
    the TF32 pair hi + lo), and the JAX conv within the op's tolerance."""
    x, wk = _operands((2, 8, 8, 16, 24), 6)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(wk).to(dtype)
    xp, wp = tgc.pack_operands(xt, wt)
    assert xp is xt
    got = tgc.conv_cgemm_packed(xp, wp)
    w_op = wt
    if dtype == torch.float32:
        assert wp.shape == (2, 24, 9 * 16)
        w_op = (wp[0] + wp[1]).reshape(24, 3, 3, 16).permute(1, 2, 3, 0)
        torch.testing.assert_close(w_op, wt, atol=0, rtol=2.0 ** -22)
    else:
        assert torch.equal(wp, tgc.pack_weights(wt))
    assert torch.equal(got, tgc.conv_cgemm_nhwc(xt, w_op))
    if dtype == torch.float32:
        want = np.asarray(jgc.conv_cgemm_nhwc(jnp.asarray(x), jnp.asarray(wk)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def _rna_tf32_reference(v: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (11 significant bits) rounded to nearest, ties away
    from zero, in float64 arithmetic: the quantum of a normal |v| in
    [2^(e-1), 2^e) is 2^(e-11), of a subnormal 2^-136."""
    v64 = v.astype(np.float64)
    _, e = np.frexp(v64)
    q = np.ldexp(1.0, np.maximum(e - 11, -136))
    with np.errstate(over="ignore"):
        r = np.copysign(np.floor(np.abs(v64) / q + 0.5) * q, v64).astype(np.float32)
    return np.where(np.isfinite(v), r, v)


def _split_cases(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":       # normal values over 2^-100 .. 2^100, both signs
        v = (rng.standard_normal(4096) * np.exp2(rng.integers(-100, 100, 4096))).astype(np.float32)
    elif case == "ties":       # the 13 dropped bits exactly half a TF32 ulp
        bits = rng.integers(0, 2 ** 31, 4096, dtype=np.uint32)
        bits = (bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
        bits[bits >> 23 == 0xFF] &= ~np.uint32(1 << 23)      # no inf/NaN
        v = bits.view(np.float32)
        v[::2] = -v[::2]
    elif case == "zeros":
        v = np.array([0.0, -0.0, 2.0 ** -149, -(2.0 ** -149)], np.float32)
    elif case == "subnormals":
        bits = rng.integers(1, 1 << 23, 4096, dtype=np.uint32)
        v = bits.view(np.float32)
        v[::2] = -v[::2]
    else:                      # infinities, and the largest finite values
        v = np.array([np.inf, -np.inf, np.finfo(np.float32).max,
                      -np.finfo(np.float32).max, 3.4e38, 1.0], np.float32)
    return v


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "subnormals", "infinities"])
def test_split_tf32_is_round_to_nearest_away_bit_for_bit(case):
    """hi = tf32(v), lo = tf32(v - hi) (0 where hi is not finite), as
    cvt.rna.tf32.f32 rounds, against a float64 rounding in numpy."""
    v = _split_cases(case)
    hi, lo = tgc.split_tf32(torch.from_numpy(v))
    want_hi = _rna_tf32_reference(v)
    with np.errstate(invalid="ignore", over="ignore"):
        want_lo = np.where(np.isfinite(want_hi), _rna_tf32_reference(v - want_hi),
                           np.float32(0.0))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()


def test_split_tf32_pair_recovers_float32_to_2_pow_minus_22():
    """hi + lo is v to 2^-22 relative; hi alone only to 2^-11 relative."""
    v = _split_cases("random")
    hi, lo = (t.numpy().astype(np.float64) for t in tgc.split_tf32(torch.from_numpy(v)))
    rel = np.abs(hi + lo - v) / np.abs(v)
    assert rel.max() <= 2.0 ** -22
    assert np.abs(hi - v).max() > 0 and (np.abs(hi - v) / np.abs(v)).max() <= 2.0 ** -11


def _conv_tf32_emulated(x: np.ndarray, wk: np.ndarray, products: int) -> np.ndarray:
    """The float32 kernel's arithmetic on the CPU: split_tf32 of both
    operands, then float32 convolutions of the TF32 parts (each product of
    two TF32 values is exact in float32): A_lo W_hi + A_hi W_lo + A_hi W_hi
    for three products, A_hi W_hi for one."""
    xh, xl = tgc.split_tf32(torch.from_numpy(x))
    wh, wl = tgc.split_tf32(torch.from_numpy(wk))
    conv = tgc.conv_cgemm_nhwc_plain
    if products == 1:
        return conv(xh, wh).numpy()
    return (conv(xl, wh) + conv(xh, wl) + conv(xh, wh)).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_emulation_holds_the_float32_limit(shape):
    """Three TF32 products stay within the float32 limit (1e-4, CONV_F32_ATOL
    in chip_smoke.py) of the JAX conv."""
    x, wk = _operands(shape, 8)
    want = np.asarray(jgc.conv_cgemm_nhwc(jnp.asarray(x), jnp.asarray(wk)))
    got = _conv_tf32_emulated(x, wk, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_1xtf32_emulation_misses_the_float32_limit():
    """One TF32 product does not hold 1e-4 (why the kernel computes three)."""
    x, wk = _operands((2, 16, 16, 64, 64), 8)
    want = np.asarray(jgc.conv_cgemm_nhwc(jnp.asarray(x), jnp.asarray(wk)))
    err = np.abs(_conv_tf32_emulated(x, wk, 1) - want).max()
    assert err > 1e-4
    assert np.abs(_conv_tf32_emulated(x, wk, 3) - want).max() < err / 100
