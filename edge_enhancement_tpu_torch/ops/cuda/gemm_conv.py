"""The 3x3 SAME stride-1 convolution on the implicit-GEMM CUDA kernel K4,
with its plain PyTorch version beside it.

Replaces edge_enhancement_tpu/ops/pallas/gemm_conv.py::_kernel, reached
there through conv_cgemm_nhwc and the differentiable conv3x3_cgemm. The
public functions keep the JAX layout: NHWC activations, HWIO weights.
`conv3x3_cgemm` runs K4 forward and, for dx, K4 again on the rot180,
in/out-swapped weights (a stride-1 SAME 3x3 conv's dgrad is the same
problem); dw is left to torch's native weight gradient, as the JAX package
leaves it to XLA's. Nothing in the model zoo calls it (as in the JAX
package); its entry point is tools/bench_gemm_conv.py.

Source and design notes: edge_enhancement_tpu_torch/csrc/gemm_conv.cu.
Activations and weights are float32 or bfloat16 (one type for both; the
weights are cast to the activations' type, as in JAX). Both types run on
tensor-core (wgmma) kernels that load 16-byte chunks: bfloat16 as one bf16
product, float32 as three TF32 products (3xTF32: each operand split into a
TF32 high and low part by `split_tf32`, the weights once at pack time, the
activations in the kernel), which keeps float32 accuracy. For both,
`conv_cgemm_nhwc` zero-pads C_in to a multiple of 8 (`pad_channels`), and
x and the packed weights must be 16-byte aligned. On a CPU tensor the
wrappers run the plain version (float32 sums, not emulated TF32); on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Launches of each kernel (one per type) since the last reset_launches();
# the wrapper adds one where it launches and nowhere else.
LAUNCHES = {"conv_cgemm_f32": 0, "conv_cgemm_bf16": 0}
_DTYPES = {torch.float32: (0, "conv_cgemm_f32"),
           torch.bfloat16: (1, "conv_cgemm_bf16")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_in, C_out) HWIO -> (C_out, 9 * C_in), tap-major."""
    kh, kw, cin, cout = w_hwio.shape
    return w_hwio.permute(3, 0, 1, 2).reshape(cout, kh * kw * cin)


def _dgrad_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """rot180 with C_in and C_out swapped: dx = conv(dy, these)."""
    return w_hwio.flip(0, 1).permute(0, 1, 3, 2)


def conv_cgemm_nhwc_plain(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """Transcription of `_kernel`: nine zero-padded shifts of x, each times
    w[dh, dw], accumulated in float32, returned in x's type."""
    _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w_hwio.to(x.dtype).float()
    acc = None
    for dh in range(3):
        for dw in range(3):
            term = xp[:, dh:dh + h, dw:dw + w, :] @ wf[dh, dw]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind csrc/gemm_conv.cu."""
    from . import build
    lib = build.load("gemm_conv")
    lib.lib.conv3x3_cgemm.argtypes = [_P] * 3 + [_I] * 6 + [_P]
    lib.lib.conv3x3_cgemm.restype = _I
    lib.lib.gemm_conv_error_string.argtypes = [_I]
    lib.lib.gemm_conv_error_string.restype = ctypes.c_char_p
    return lib


def pad_channels(x: torch.Tensor, w_hwio: torch.Tensor):
    """Zero-pad the input channels of x (B, H, W, C_in) and w (3, 3, C_in,
    C_out) up to the next multiple of 8, whole 16-byte chunks for both
    kernels; the zero channels add nothing to any sum. Returns (x, w)
    unchanged when C_in % 8 == 0."""
    pad = -x.shape[-1] % 8
    if pad == 0:
        return x, w_hwio
    return F.pad(x, (0, pad)), F.pad(w_hwio, (0, 0, 0, pad))


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as cvt.rna.tf32.f32 rounds: add half a TF32 ulp to the magnitude
    bits and clear the 13 low bits. Infinities and NaNs pass through."""
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v)


def split_tf32(v: torch.Tensor):
    """float32 v -> (hi, lo), both TF32: hi = tf32(v), lo = tf32(v - hi),
    so hi + lo is v to 2^-22 relative; lo = 0 where hi is not finite. The
    float32 kernel splits the activations the same way."""
    hi = _round_tf32(v)
    lo = torch.where(torch.isfinite(hi), _round_tf32(v - hi), torch.zeros_like(v))
    return hi, lo


def conv_cgemm_packed_plain(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The plain version on packed weights: (C_out, 9 * C_in), or for
    float32 the (2, C_out, 9 * C_in) TF32 pair, which stands for hi + lo."""
    if w_packed.dim() == 3:
        w_packed = w_packed[0] + w_packed[1]
    cout, cin = w_packed.shape[0], x.shape[-1]
    return conv_cgemm_nhwc_plain(x, w_packed.reshape(cout, 3, 3, cin).permute(1, 2, 3, 0))


def conv_cgemm_packed(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """K4 on NHWC x and weights packed once by `pack_operands` (C_in % 8 ==
    0, both 16-byte aligned; float32 weights as their (2, C_out, 9 * C_in)
    TF32 pair): the kernel alone, one launch. The plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return conv_cgemm_packed_plain(x, w_packed)
    if x.device.type != "cuda":
        raise ValueError(f"conv_cgemm_packed takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, C) float32 or "
                         f"bfloat16 tensor (got {x.dtype}, shape {tuple(x.shape)})")
    b, h, w, cin = x.shape
    lead = (2,) if x.dtype == torch.float32 else ()
    if (tuple(w_packed.shape[:-2]) != lead or w_packed.dim() != len(lead) + 2
            or w_packed.shape[-1] != 9 * cin or w_packed.dtype != x.dtype
            or w_packed.device != x.device or not w_packed.is_contiguous()):
        raise ValueError(f"packed weights must be a contiguous {lead + ('C_out', 9 * cin)} "
                         f"{x.dtype} tensor on {x.device}, got {tuple(w_packed.shape)} "
                         f"{w_packed.dtype} on {w_packed.device}")
    if cin % 8:
        raise ValueError(f"the kernels take C_in % 8 == 0, got {cin} "
                         "(pad_channels pads it)")
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("the kernels load 16-byte chunks: x and the packed "
                         "weights must be 16-byte aligned")
    cout = w_packed.shape[-2]
    out = x.new_empty((b, h, w, cout))
    code, name = _DTYPES[x.dtype]
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.lib.conv3x3_cgemm(
            x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
            code, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_cgemm launch failed: "
                           f"{lib.lib.gemm_conv_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return out


def pack_operands(x: torch.Tensor, w_hwio: torch.Tensor):
    """(x, packed weights) as K4 takes them: C_in zero-padded to a multiple
    of 8 (`pad_channels`), the weights cast to x's type and packed by
    `pack_weights`; for float32, split into their (2, C_out, 9 * C_in) TF32
    high and low parts (`split_tf32`)."""
    cin = x.shape[-1]
    if tuple(w_hwio.shape[:3]) != (3, 3, cin) or w_hwio.device != x.device:
        raise ValueError(f"weights must be (3, 3, {cin}, C_out) on {x.device}, "
                         f"got {tuple(w_hwio.shape)} on {w_hwio.device}")
    x, w_hwio = pad_channels(x, w_hwio.to(x.dtype))
    w_packed = pack_weights(w_hwio)
    if x.dtype == torch.float32:
        w_packed = torch.stack(split_tf32(w_packed))
    return x, w_packed.contiguous()


def conv_cgemm_nhwc(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv, NHWC x HWIO -> NHWC: K4 on a CUDA tensor
    (operands prepared by `pack_operands` on each call), the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return conv_cgemm_nhwc_plain(x, w_hwio)
    return conv_cgemm_packed(*pack_operands(x, w_hwio))


class Conv3x3CGemm(torch.autograd.Function):
    """K4 forward; dx on K4 with the dgrad weights, dw from torch's native
    weight gradient."""

    @staticmethod
    def forward(ctx, x, w_hwio):
        ctx.save_for_backward(x, w_hwio)
        return conv_cgemm_nhwc(x, w_hwio)

    @staticmethod
    def backward(ctx, dy):
        x, w_hwio = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv_cgemm_nhwc(dy, _dgrad_weights(w_hwio))
        dw_oihw = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (w_hwio.shape[3], w_hwio.shape[2], 3, 3),
            dy.permute(0, 3, 1, 2), padding=1)
        return dx, dw_oihw.permute(2, 3, 1, 0).to(w_hwio.dtype)


def conv3x3_cgemm(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """Differentiable SAME 3x3 stride-1 conv (NHWC x HWIO -> NHWC) on K4."""
    return Conv3x3CGemm.apply(x, w_hwio)
