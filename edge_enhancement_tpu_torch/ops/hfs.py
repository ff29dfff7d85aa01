"""High-frequency suppression as two per-axis matrix products, as
edge_enhancement_tpu/ops/hfs.py: Re(ifft2(fft2(x) * mask)) equals
Re(A) x Re(B)^T - Im(A) x Im(B)^T with A = iF diag(m_row) F, B likewise.
torch.fft appears only in the tests, as the oracle."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def hfs_mask(h: int, w: int, r: int) -> np.ndarray:
    """Binary low-pass mask in FFT index order, shape (h, w)."""
    mask = np.zeros((h, w), dtype=np.float32)
    ch, cw = h // 2, w // 2
    dh = r if h % 2 == 0 else r + 1
    dw = r if w % 2 == 0 else r + 1
    mask[max(ch - r, 0):ch + dh, max(cw - r, 0):cw + dw] = 1.0
    mask = np.roll(mask, -ch, axis=0)
    mask = np.roll(mask, -cw, axis=1)
    return mask


@functools.lru_cache(maxsize=None)
def _hfs_axis_operators(h: int, w: int, r: int):
    """(Re A, Im A, Re B, Im B) as float32 numpy arrays."""
    mask = hfs_mask(h, w, r)
    row_any = mask.max(axis=1)
    col_any = mask.max(axis=0)
    if not np.allclose(np.outer(row_any, col_any), mask):
        raise ValueError("HFS mask is not separable")
    fh = np.fft.fft(np.eye(h), axis=0)
    fw = np.fft.fft(np.eye(w), axis=0)
    a = np.fft.ifft(row_any[:, None] * fh, axis=0)
    b = np.fft.ifft(col_any[:, None] * fw, axis=0)
    return (a.real.astype(np.float32), a.imag.astype(np.float32),
            b.real.astype(np.float32), b.imag.astype(np.float32))


def hfs_nchw(x: torch.Tensor, ar, ai, br, bi) -> torch.Tensor:
    """A-contraction first, then B, for each (image, channel) plane of a
    (B, C, H, W) tensor; the operators are (H, H) and (W, W) tensors.

    A bfloat16 x takes JAX's casts (edge_enhancement_tpu/ops/hfs.py and the
    fused kernel's `_hfs_sandwich`): the operators rounded to bfloat16, the
    products summed in float32 (`preferred_element_type`), A x rounded to
    bfloat16 before the second product, and the float32 difference of the
    two sandwiches rounded once."""
    if x.dtype == torch.float32:
        return (ar @ x) @ br.T - (ai @ x) @ bi.T
    dt = x.dtype
    xf = x.float()

    def sandwich(a, b):
        t = (a.to(dt).float() @ xf).to(dt).float()
        return t @ b.to(dt).float().T

    return (sandwich(ar, br) - sandwich(ai, bi)).to(dt)


def high_freq_suppress(x: torch.Tensor, r: int) -> torch.Tensor:
    """Low-pass filter each channel of an NHWC batch."""
    h, w = x.shape[1], x.shape[2]
    ar, ai, br, bi = (torch.from_numpy(m).to(x.device, x.dtype)
                      for m in _hfs_axis_operators(h, w, r))
    return hfs_nchw(x.permute(0, 3, 1, 2), ar, ai, br, bi).permute(0, 2, 3, 1)
