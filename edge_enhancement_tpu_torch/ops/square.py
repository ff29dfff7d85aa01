"""Square-attack-style input perturbation with one query, as
edge_enhancement_tpu/ops/square.py (`add_square` with n_queries=1).

The draws are made apart from the arithmetic, in the layout of the JAX
`add_square_draws` — stripes (B, 1, W, C), square mask (H, W), channel sign
(1, 1, 1, C) — so a test can hand both packages the same draws. Gradients
flow through the clips as in JAX: `clip01` splits ties 0.5/0.5 (torch.clamp
would pass 1 at the bounds).
"""

from __future__ import annotations

import math

import torch

from .stencil import weak_scalar


def p_selection(it: int, p_init: float) -> float:
    """Decaying square-size schedule over the query index `it`."""
    thresholds = [(8000, 512), (6000, 256), (4000, 128), (2000, 64),
                  (1000, 32), (500, 16), (200, 8), (50, 4), (10, 2)]
    for lo, div in thresholds:
        if it > lo:
            return p_init / div
    return p_init


def square_side(h: int, c: int, p_init: float = 0.8) -> int:
    """Side of the first query's square, round(sqrt(p * H^2)), in the JAX
    expression's own float order."""
    p = p_selection(0, p_init)
    return max(int(round(math.sqrt(p * (c * h * h) / c))), 1)


def clip01(v: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, 1) with JAX's gradient: 0.5 at an exact bound."""
    return torch.minimum(torch.maximum(v, torch.zeros_like(v)),
                         torch.ones_like(v))


def add_square_draws(shape, generator: torch.Generator, *,
                     p_init: float = 0.8):
    """Fresh draws for one add_square call on an NHWC batch of `shape`,
    made on the generator's device without a host sync."""
    b, h, w, c = shape
    dev = generator.device
    stripes = torch.sign(
        2.0 * torch.rand((b, 1, w, c), generator=generator, device=dev) - 1.0)
    s = square_side(h, c, p_init)
    vh = torch.floor(torch.rand((), generator=generator, device=dev) * (h - s))
    rows = torch.arange(h, device=dev)
    in_span = (rows >= vh) & (rows < vh + s)
    mask = (in_span[:, None] & in_span[None, :]).float()
    sign = torch.sign(
        2.0 * torch.rand((1, 1, 1, c), generator=generator, device=dev) - 1.0)
    return stripes, mask, sign


def kernel_layout(draws, epsilon: float, dtype=torch.float32):
    """JAX-layout draws -> (stripes (B, C, 1, W), sq_delta (1, C, H, W)) with
    sq_delta = 2 eps sign mask, the operands of the fused front-end."""
    stripes, mask, sign = draws
    stripes_k = stripes.permute(0, 3, 1, 2).to(dtype).contiguous()
    sq_delta = (2.0 * epsilon * sign.permute(0, 3, 1, 2)
                * mask[None, None]).to(dtype).contiguous()
    return stripes_k, sq_delta


def square_forward_nchw(x, stripes, sq_delta, epsilon: float):
    """add_square (n_queries=1) on (B, C, H, W) with kernel-layout draws, in
    x's dtype (epsilon rounded to it, as JAX's weak typing does)."""
    eps = weak_scalar(epsilon, x.dtype)
    t2 = clip01(x + eps * stripes)
    t3 = t2 + sq_delta
    t5 = torch.minimum(torch.maximum(t3, x - eps), x + eps)
    return clip01(t5)


def add_square(x: torch.Tensor, draws, *, epsilon: float = 0.05) -> torch.Tensor:
    """The perturbation on an NHWC batch with JAX-layout draws."""
    stripes, sq_delta = kernel_layout(draws, epsilon, x.dtype)
    return square_forward_nchw(x.permute(0, 3, 1, 2), stripes, sq_delta,
                               epsilon).permute(0, 2, 3, 1)
