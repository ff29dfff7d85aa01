"""The edge-enhancement front-end in plain PyTorch: the square, the HFS
products, the BPDA-3 Canny (`CannyFilter_step125_1`) and the clip, on an
NCHW batch, with autograd giving the gradient that the BPDA Canny defines.

A frozen copy of the plain arithmetic of edge_enhancement_tpu_torch/ops
(hfs.py, square.py, stencil.py, filters.py, ste.py, canny.py's step125
path and ops/cuda/ee_fused.py's `ee_fused_fwd_plain`), so that the
benchmark's reference stays what it is when the program changes. It
imports nothing of the program. One departure: the backward is torch's
autograd of this forward, not a transcription of the kernel's adjoint
(in float32 the two agree to rounding; under bfloat16 the adjoint's casts
differ by an ulp here and there).

The square's draws are made here too (`square_draws`), in the order and
with the calls that the program makes them on its generator, so that a
generator seeded alike hands both sides the same draws.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def weak_scalar(v: float, dtype: torch.dtype) -> float:
    """A Python float as it enters an operation on a `dtype` tensor:
    rounded to `dtype` (a no-op for float32)."""
    if dtype == torch.float32:
        return float(v)
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))


def gaussian_kernel(k: int = 3, mu: float = 0.0, sigma: float = 1.0) -> np.ndarray:
    """k x k normalised Gaussian on a [-1, 1]^2 grid."""
    line = np.linspace(-1, 1, k)
    x, y = np.meshgrid(line, line)
    dist = np.sqrt(x ** 2 + y ** 2)
    g = np.exp(-((dist - mu) ** 2) / (2 * sigma ** 2)) / (2 * np.pi * sigma ** 2)
    return (g / g.sum()).astype(np.float32)


def sobel_kernel(k: int = 3) -> np.ndarray:
    """k x k Sobel-x kernel x / (x^2 + y^2)."""
    line = np.linspace(-(k // 2), k // 2, k)
    x, y = np.meshgrid(line, line)
    denom = x ** 2 + y ** 2
    denom[:, k // 2] = 1.0
    return (x / denom).astype(np.float32)


def stencil2d(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Depthwise 'same' cross-correlation of (B, C, H, W) with the border
    replicated, tap by tap in row-major order, zero taps skipped."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (pw, pw, ph, ph), mode="replicate")
    h, w = x.shape[2], x.shape[3]
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(kernel[i, j])
            if c == 0.0:
                continue
            term = weak_scalar(c, x.dtype) * xp[:, :, i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


class _ToCompare(torch.autograd.Function):
    """1[x > t]; the gradient passes where t < x <= 1.001."""

    @staticmethod
    def forward(ctx, x, threshold):
        ctx.save_for_backward(x)
        ctx.threshold = threshold
        return (x > threshold).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x > ctx.threshold) & (x <= 1.001)
        return torch.where(keep, g, torch.zeros_like(g)), None


def _magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2), with a zero gradient where it is exactly zero."""
    v = gx * gx + gy * gy
    zero = v == 0.0
    return torch.where(zero, torch.zeros_like(v),
                       torch.sqrt(torch.where(zero, torch.ones_like(v), v)))


def canny_step125(x: torch.Tensor, high: float, sigma: float, alpha: float) -> torch.Tensor:
    """(B, C, H, W) -> (B, 1, H, W) edge map in {0, 1}, in x's dtype: the
    blur of each channel, the channel sum (float32, rounded once), the
    Sobel pair divided by C and the magnitude in float32, the alpha mask and
    the threshold at `high`."""
    c = x.shape[1]
    blurred = stencil2d(x, gaussian_kernel(3, 0.0, sigma))
    summed = blurred.float()[:, :1]
    for i in range(1, c):
        summed = summed + blurred.float()[:, i:i + 1]
    summed = summed.to(x.dtype)
    sob = sobel_kernel(3)
    cdiv = torch.full((), float(c), dtype=torch.float32, device=x.device)
    gx = stencil2d(summed, sob).float() / cdiv
    gy = stencil2d(summed, sob.T.copy()).float() / cdiv
    mag = _magnitude(gx, gy)
    mag = torch.where(mag < alpha, torch.zeros_like(mag), mag)
    return _ToCompare.apply(mag, float(high)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def hfs_operators(h: int, w: int, r: int):
    """(Re A, Im A, Re B, Im B), float32 numpy: the low-pass mask of radius
    r in FFT order, separated into one operator an axis."""
    mask = np.zeros((h, w), dtype=np.float32)
    ch, cw = h // 2, w // 2
    dh = r if h % 2 == 0 else r + 1
    dw = r if w % 2 == 0 else r + 1
    mask[max(ch - r, 0):ch + dh, max(cw - r, 0):cw + dw] = 1.0
    mask = np.roll(np.roll(mask, -ch, axis=0), -cw, axis=1)
    rows, cols = mask.max(axis=1), mask.max(axis=0)
    a = np.fft.ifft(rows[:, None] * np.fft.fft(np.eye(h), axis=0), axis=0)
    b = np.fft.ifft(cols[:, None] * np.fft.fft(np.eye(w), axis=0), axis=0)
    return tuple(m.astype(np.float32) for m in (a.real, a.imag, b.real, b.imag))


def hfs(x: torch.Tensor, r: int) -> torch.Tensor:
    """Re(ifft2(fft2(x) mask)) as (A x) B^T products, each plane of (B, C,
    H, W). bfloat16: the operators rounded to it, the products summed in
    float32, A x rounded before the second product, the difference rounded
    once."""
    ar, ai, br, bi = (torch.from_numpy(m).to(x.device)
                      for m in hfs_operators(x.shape[2], x.shape[3], r))
    if x.dtype == torch.float32:
        return (ar @ x) @ br.T - (ai @ x) @ bi.T
    dt, xf = x.dtype, x.float()

    def sandwich(a, b):
        return (a.to(dt).float() @ xf).to(dt).float() @ b.to(dt).float().T

    return (sandwich(ar, br) - sandwich(ai, bi)).to(dt)


def clip01(v: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, 1), half the gradient to each side at an exact bound."""
    return torch.minimum(torch.maximum(v, torch.zeros_like(v)), torch.ones_like(v))


def square_side(h: int, p_init: float = 0.8) -> int:
    """The side of the first (and only) query's square."""
    return max(int(round(math.sqrt(p_init * (3 * h * h) / 3))), 1)


def square_draws(shape, generator: torch.Generator):
    """One forward's square draws for an NHWC batch of `shape`, made as
    the program makes them on its generator: the stripes' uniforms (B, 1,
    W, C), the square's position, the channel signs' uniforms (1, 1, 1, C).
    Returns (stripes (B, C, 1, W), sign mask (1, C, H, W)) in float32."""
    b, h, w, c = shape
    dev = generator.device
    stripes = torch.sign(2.0 * torch.rand((b, 1, w, c), generator=generator, device=dev) - 1.0)
    s = square_side(h)
    vh = torch.floor(torch.rand((), generator=generator, device=dev) * (h - s))
    rows = torch.arange(h, device=dev)
    span = (rows >= vh) & (rows < vh + s)
    mask = (span[:, None] & span[None, :]).float()
    sign = torch.sign(2.0 * torch.rand((1, 1, 1, c), generator=generator, device=dev) - 1.0)
    return stripes.permute(0, 3, 1, 2), sign.permute(0, 3, 1, 2) * mask[None, None]


def add_square(x: torch.Tensor, draws, eps: float) -> torch.Tensor:
    """Stripes of +-eps, clipped; the square moved by 2 eps sign, projected
    to the eps-ball around x and clipped; in x's dtype."""
    stripes, signed_mask = draws
    sq_delta = (2.0 * eps * signed_mask).to(x.dtype)
    e = weak_scalar(eps, x.dtype)
    t = clip01(x + e * stripes.to(x.dtype))
    t = torch.minimum(torch.maximum(t + sq_delta, x - e), x + e)
    return clip01(t)


def frontend(x: torch.Tensor, ee: dict, draws=None) -> torch.Tensor:
    """out = clip(HFS(square(x)) + w Canny(x), 0, 1) on an NHWC batch, in
    its dtype; `draws` from `square_draws` when ee['square']."""
    x = x.permute(0, 3, 1, 2).contiguous()
    xs = add_square(x, draws, ee["epsilon"]) if ee["square"] else x
    edge = canny_step125(x, ee["high"] / 255.0, ee["sigma"], ee["alpha"])
    y = hfs(xs, ee["r"]) + weak_scalar(ee["w"], x.dtype) * edge
    return clip01(y).permute(0, 2, 3, 1)
