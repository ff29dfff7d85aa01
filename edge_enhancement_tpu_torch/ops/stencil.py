"""Small fixed-kernel convolutions as shifted multiply-adds.

Mirrors edge_enhancement_tpu/ops/stencil.py: the taps are applied in
row-major order with zero taps skipped, each product and sum rounded on its
own, so the result equals the JAX stencil bit for bit (the hard Canny
threshold downstream flips on one-ulp differences). In bfloat16 that holds
too: JAX rounds a Python-float tap to bfloat16 before it multiplies (weak
typing), and so does `weak_scalar` here; torch would keep it in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def weak_scalar(v: float, dtype: torch.dtype) -> float:
    """The Python float `v` as JAX's weak typing takes it into an operation
    on a `dtype` array: rounded to `dtype` (a no-op for float32 operands,
    whose scalars torch and JAX both take in float32)."""
    if dtype == torch.float32:
        return float(v)
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))


def stencil_taps(kernel: np.ndarray) -> list[tuple[int, int, float]]:
    """(dh, dw, coeff) of the nonzero entries, row-major."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    return [(i - kh // 2, j - kw // 2, float(kernel[i, j]))
            for i in range(kh) for j in range(kw) if float(kernel[i, j]) != 0.0]


def stencil2d_nchw(x: torch.Tensor, kernel: np.ndarray,
                   pad_mode: str = "edge") -> torch.Tensor:
    """Depthwise 'same' cross-correlation of a (B, C, H, W) tensor; 'edge'
    replicates the border, 'zero' pads with zeros."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    mode = {"edge": "replicate", "zero": "constant"}[pad_mode]
    xp = F.pad(x, (pw, pw, ph, ph), mode=mode)
    h, w = x.shape[2], x.shape[3]
    out = None
    for dh, dw, coeff in stencil_taps(kernel):
        i, j = dh + ph, dw + pw
        term = weak_scalar(coeff, x.dtype) * xp[:, :, i:i + h, j:j + w]
        out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def stencil2d(x: torch.Tensor, kernel: np.ndarray,
              pad_mode: str = "edge") -> torch.Tensor:
    """`stencil2d_nchw` on an NHWC tensor (the JAX layout)."""
    return stencil2d_nchw(x.permute(0, 3, 1, 2), kernel,
                          pad_mode).permute(0, 2, 3, 1)


def shift2d_nchw(x: torch.Tensor, drow: int, dcol: int) -> torch.Tensor:
    """out[b, c, r, s] = x[b, c, r + drow, s + dcol], zero outside the image
    (|drow|, |dcol| <= 1)."""
    xp = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[2], x.shape[3]
    return xp[:, :, 1 + drow:1 + drow + h, 1 + dcol:1 + dcol + w]
