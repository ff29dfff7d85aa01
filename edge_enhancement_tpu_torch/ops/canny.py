"""The BPDA-3 Canny (`CannyFilter_step125_1`): blur -> Sobel -> magnitude ->
alpha mask -> To_compare threshold, as edge_enhancement_tpu/ops/canny.py.

Only this variant is on the ported path; `canny` and `canny_bpda` (NMS,
hysteresis) are later work.
"""

from __future__ import annotations

import torch

from .filters import gaussian_kernel, sobel_kernel
from .stencil import stencil2d_nchw
from .ste import to_compare


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


def _blur_sobel_magnitude_nchw(x: torch.Tensor, sigma: float):
    """Per-channel Gaussian blur, channel sum BEFORE the Sobel (padding and
    the channel sum commute; this order decides exact ties as the JAX code
    does), Sobel / C, magnitude. x: (B, C, H, W); returns (B, 1, H, W) each
    of gx, gy, magnitude, in float32.

    A bfloat16 x takes the casts of the JAX fused kernel's
    `_canny125_forward`: the blur and the Sobel taps in bfloat16, each
    product and sum rounded; the channel sum in float32, rounded once (jnp
    sums low-precision floats in float32); the division by C and the
    magnitude in float32."""
    c = x.shape[1]
    blurred = stencil2d_nchw(x, gaussian_kernel(3, 0.0, sigma), "edge")
    summed = _channel_sum(blurred.float()).to(x.dtype)
    sob = sobel_kernel(3)
    # divide by a tensor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which can differ by one ulp (made on
    # the device, so a CUDA graph can capture it)
    cdiv = torch.full((), float(c), dtype=torch.float32, device=summed.device)
    grad_x = stencil2d_nchw(summed, sob, "edge").float() / cdiv
    grad_y = stencil2d_nchw(summed, sob.T, "edge").float() / cdiv
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
