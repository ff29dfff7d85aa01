"""The differentiable Canny filters of edge_enhancement_tpu/ops/canny.py,
NCHW inside (the `_nchw` functions), NHWC at the public ones:

* `canny` (CannyFilter): blur, channel-summed Sobel, magnitude and
  orientation, alpha mask, 8-direction non-maximum suppression, the
  BinaryConnect double threshold, optional hysteresis (gradient through
  `high` only);
* `canny_bpda` (CannyFilter_BPDA): every non-differentiable step an STE
  (To_compare, To_eq), no alpha mask;
* `canny_step125` (CannyFilter_step125_1, the BPDA-3 Canny): blur, Sobel,
  magnitude, alpha mask, the To_compare threshold at `high`.

All three take float32 or bfloat16 (the bf16 policy), each bfloat16
operation rounded where JAX rounds it: its Python-float constants are taken
as JAX's weak typing takes them (`weak_scalar`), and its comparisons with a
Python float compare in bfloat16, as torch's do. The step125 variant runs on
the kernels of ops/cuda/ee_fused.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .filters import direction_offsets, gaussian_kernel, hysteresis_kernel, sobel_kernel
from .stencil import shift2d_nchw, stencil2d_nchw, weak_scalar
from .ste import binary_connect, to_compare, to_eq

_DEG_PER_RAD = 360.0 / math.pi  # the reference converts with 360/pi


def _safe_magnitude(grad_x: torch.Tensor, grad_y: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) with a ZERO gradient at exactly-zero magnitude
    (torch's own sqrt back-propagates NaN there; constant image regions
    make exact zeros common)."""
    v = grad_x * grad_x + grad_y * grad_y
    is_zero = v == 0.0
    safe_v = torch.where(is_zero, torch.ones_like(v), v)
    return torch.where(is_zero, torch.zeros_like(v), torch.sqrt(safe_v))


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in channel order, keepdim — a fixed order, so the sum
    rounds the same on every device."""
    out = x[:, :1]
    for c in range(1, x.shape[1]):
        out = out + x[:, c:c + 1]
    return out


def _blur_sobel_magnitude_nchw(x: torch.Tensor, sigma: float, wide: bool = True):
    """Per-channel Gaussian blur, channel sum BEFORE the Sobel (padding and
    the channel sum commute; this order decides exact ties as the JAX code
    does), Sobel / C, magnitude. x: (B, C, H, W); returns (B, 1, H, W) each
    of gx, gy, magnitude.

    A bfloat16 x rounds each product and sum of the blur and the Sobel taps
    to bfloat16, and the channel sum in float32, rounded once (jnp sums
    low-precision floats in float32). With `wide` (the casts of the JAX
    fused kernel's `_canny125_forward`, K1/K2's) the division by C and the
    magnitude are float32, and so are the results; without it (JAX's
    ops/canny.py and its Canny-only kernel, K3a/K3b's) they are in x's
    dtype, each operation rounded. float32 computes the same either way."""
    c = x.shape[1]
    blurred = stencil2d_nchw(x, gaussian_kernel(3, 0.0, sigma), "edge")
    summed = _channel_sum(blurred.float()).to(x.dtype)
    sob = sobel_kernel(3)
    dt = torch.float32 if wide else x.dtype
    # divide by a tensor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which can differ by one ulp (made on
    # the device, so a CUDA graph can capture it)
    cdiv = torch.full((), float(c), dtype=dt, device=summed.device)
    grad_x = stencil2d_nchw(summed, sob, "edge").to(dt) / cdiv
    grad_y = stencil2d_nchw(summed, sob.T, "edge").to(dt) / cdiv
    return grad_x, grad_y, _safe_magnitude(grad_x, grad_y)


def canny_step125_nchw(x: torch.Tensor, high_threshold: float, *,
                       sigma: float = 1.0, alpha: float = 0.0) -> torch.Tensor:
    """(B, C, H, W) -> (B, 1, H, W) edge map in {0, 1}, in x's dtype."""
    _, _, magnitude = _blur_sobel_magnitude_nchw(x, sigma)
    magnitude = torch.where(magnitude < alpha, torch.zeros_like(magnitude),
                            magnitude)
    return to_compare(magnitude, float(high_threshold)).to(x.dtype)


def canny_step125(img: torch.Tensor, high_threshold: float, *,
                  sigma: float = 1.0, alpha: float = 0.0) -> torch.Tensor:
    """NHWC -> (B, H, W, 1), the layout of the JAX `canny_step125`."""
    edge = canny_step125_nchw(img.permute(0, 3, 1, 2), high_threshold,
                              sigma=sigma, alpha=alpha)
    return edge.permute(0, 2, 3, 1)


def _by(v: torch.Tensor, d: float) -> torch.Tensor:
    """v / d, true division on every device (CUDA multiplies by the
    reciprocal of a Python scalar divisor)."""
    return v / torch.full((), d, dtype=v.dtype, device=v.device)


def _nms(magnitude, grad_x, grad_y):
    """8-direction non-maximum suppression on (B, 1, H, W): the orientation
    atan(gy / gx) (atan, not atan2: gx == 0 gives +-pi/2, 0/0 NaN, which no
    bin takes) in 45-degree bins, and a pixel zeroed where its orientation's
    two neighbours do not both lie strictly below it. The orientation feeds
    comparisons only; it is computed from detached gradients, so 0/0's NaN
    never reaches the backward. The test is strict: an exact magnitude tie
    across an edge (an ideal binary step) suppresses both pixels, as in
    JAX, whose channel-sum-first order computes the same exact tie. In
    bfloat16 the orientation and its degrees round as JAX rounds them (the
    constant 360 / pi taken in bfloat16)."""
    orientation = torch.atan(grad_y.detach() / grad_x.detach())
    degrees = (orientation * weak_scalar(_DEG_PER_RAD, orientation.dtype)
               + weak_scalar(180.0, orientation.dtype))
    positive_idx = torch.remainder(torch.round(_by(degrees, 45.0)), 8.0)
    directional = [magnitude - shift2d_nchw(magnitude, dr, dc)
                   for dr, dc in direction_offsets()]
    zero = torch.zeros_like(magnitude)
    thin = magnitude
    for pos_i in range(4):
        neg_i = pos_i + 4
        is_oriented = (positive_idx == pos_i) | (positive_idx == neg_i)
        is_max = torch.minimum(directional[pos_i], directional[neg_i]) > 0.0
        thin = torch.where((~is_max) & is_oriented, zero, thin)
    return thin


def canny_nchw(x: torch.Tensor, low_threshold: Optional[float] = None,
               high_threshold: Optional[float] = None, hysteresis: bool = False,
               *, sigma: float = 1.0, alpha: float = 0.0) -> torch.Tensor:
    """The full Canny (reference CannyFilter.forward), (B, C, H, W) ->
    (B, 1, H, W) in x's dtype."""
    grad_x, grad_y, magnitude = _blur_sobel_magnitude_nchw(x, sigma, wide=False)
    magnitude = torch.where(magnitude < alpha, torch.zeros_like(magnitude), magnitude)
    thin = _nms(magnitude, grad_x, grad_y)
    if low_threshold is None:
        return thin
    low = (binary_connect(thin - weak_scalar(low_threshold, x.dtype)) + 1.0) / 2.0
    if high_threshold is None:
        return low
    high = (binary_connect(thin - weak_scalar(high_threshold, x.dtype)) + 1.0) / 2.0
    thin = low * 0.5 + high * 0.5
    if hysteresis:
        # built from comparisons (no STE), so gradient flows through `high` only
        weak = (thin == 0.5).to(thin.dtype)
        votes = stencil2d_nchw(thin, hysteresis_kernel(), "zero")
        weak_is_high = (votes > 1.0).to(thin.dtype) * weak
        thin = high + weak_is_high.detach()
    return thin


def canny_bpda_nchw(x: torch.Tensor, low_threshold: Optional[float] = None,
                    high_threshold: Optional[float] = None, hysteresis: bool = False,
                    *, sigma: float = 1.0, alpha: float = 0.0) -> torch.Tensor:
    """The BPDA Canny (reference CannyFilter_BPDA.forward): STE thresholds,
    multiplicative NMS, no alpha mask; the un-thresholded `thin` when only
    `low_threshold` is given. (B, C, H, W) -> (B, 1, H, W) in x's dtype."""
    del alpha  # kept for the constructor's signature; the BPDA forward never masks
    grad_x, grad_y, magnitude = _blur_sobel_magnitude_nchw(x, sigma, wide=False)
    thin = _nms(magnitude, grad_x, grad_y)
    if low_threshold is None:
        return thin
    low = to_compare(thin, float(low_threshold))
    if high_threshold is None:
        return thin
    high = to_compare(thin, float(high_threshold))
    thin = low * 0.5 + high * 0.5
    if hysteresis:
        weak = to_eq(thin)
        votes = stencil2d_nchw(thin, hysteresis_kernel(), "zero")
        thin = high + to_compare(votes, 1.0) * weak
    return thin


# name -> (B, C, H, W) function (x, low, high, hysteresis, *, sigma, alpha)
# of the variants that run in plain PyTorch; CannyFilter_step125_1 runs on
# the kernels of ops/cuda/ee_fused.py (canny_step125_nchw is their oracle)
CANNY_VARIANTS = {
    "CannyFilter": canny_nchw,
    "CannyFilter_BPDA": canny_bpda_nchw,
}


def canny(img: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """canny_nchw on an NHWC batch, (B, H, W, 1) out."""
    return canny_nchw(img.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def canny_bpda(img: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """canny_bpda_nchw on an NHWC batch, (B, H, W, 1) out."""
    return canny_bpda_nchw(img.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)
