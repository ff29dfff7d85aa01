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
weights are cast to the activations' type, as in JAX). On a CPU tensor the
wrappers run the plain version; on a CUDA tensor they launch the kernel or
raise.
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


def conv_cgemm_nhwc(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv, NHWC x HWIO -> NHWC: K4 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return conv_cgemm_nhwc_plain(x, w_hwio)
    if x.device.type != "cuda":
        raise ValueError(f"conv_cgemm_nhwc takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, C) float32 or "
                         f"bfloat16 tensor (got {x.dtype}, shape {tuple(x.shape)})")
    b, h, w, cin = x.shape
    if tuple(w_hwio.shape[:3]) != (3, 3, cin) or w_hwio.device != x.device:
        raise ValueError(f"weights must be (3, 3, {cin}, C_out) on {x.device}, "
                         f"got {tuple(w_hwio.shape)} on {w_hwio.device}")
    cout = w_hwio.shape[3]
    wp = pack_weights(w_hwio).to(x.dtype).contiguous()
    out = x.new_empty((b, h, w, cout))
    code, name = _DTYPES[x.dtype]
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.lib.conv3x3_cgemm(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
            code, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_cgemm launch failed: "
                           f"{lib.lib.gemm_conv_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return out


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
