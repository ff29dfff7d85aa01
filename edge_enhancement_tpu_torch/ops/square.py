"""Square-attack-style input perturbation, as
edge_enhancement_tpu/ops/square.py (`add_square`): vertical stripes
x + eps sign, clipped to [0, 1]; then for each query i one square of side
s_i (p_selection's schedule) at one position (vh, vh), the same for the
whole batch, moved by 2 eps sign_c per channel, the result projected to
the eps-ball around x and clipped to [0, 1].

The draws are made apart from the arithmetic, in the layout of the JAX
`add_square_draws` (stripes (B, 1, W, C), then each query's square mask
(H, W) and channel sign (1, 1, 1, C); with more than one query the masks
and signs are stacked on a leading query axis), so a test can hand both
packages the same draws. Gradients flow through the clips as in JAX:
`clip01` and the projection split ties 0.5/0.5 (torch.clamp would pass 1
at the bounds).
"""

from __future__ import annotations

import math

import torch

from ..parallel import mesh
from .stencil import weak_scalar


def p_selection(it: int, p_init: float, n_queries: int = 1,
                rescale_schedule: bool = False) -> float:
    """Decaying square-size schedule over the query index `it`."""
    if rescale_schedule:
        it = int(it / n_queries * 10000)
    thresholds = [(8000, 512), (6000, 256), (4000, 128), (2000, 64),
                  (1000, 32), (500, 16), (200, 8), (50, 4), (10, 2)]
    for lo, div in thresholds:
        if it > lo:
            return p_init / div
    return p_init


def square_side(h: int, c: int, p_init: float = 0.8, it: int = 0,
                n_queries: int = 1, rescale_schedule: bool = False) -> int:
    """Side of query `it`'s square, round(sqrt(p * C H^2 / C)), in the JAX
    expression's own float order."""
    p = p_selection(it, p_init, n_queries, rescale_schedule)
    return max(int(round(math.sqrt(p * (c * h * h) / c))), 1)


def clip01(v: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, 1) with JAX's gradient: 0.5 at an exact bound."""
    return torch.minimum(torch.maximum(v, torch.zeros_like(v)),
                         torch.ones_like(v))


def add_square_draws(shape, generator: torch.Generator, *, p_init: float = 0.8,
                     n_queries: int = 1, rescale_schedule: bool = False):
    """Fresh draws for one add_square call on an NHWC batch of `shape`,
    made on the generator's device without a host sync: the stripes, then
    each query's position and channel sign."""
    b, h, w, c = shape
    dev = generator.device
    stripes = torch.sign(2.0 * mesh.draw_rows(
        lambda s: torch.rand(s, generator=generator, device=dev), (b, 1, w, c)) - 1.0)
    rows = torch.arange(h, device=dev)
    masks, signs = [], []
    for i in range(n_queries):
        s = square_side(h, c, p_init, i, n_queries, rescale_schedule)
        vh = torch.floor(torch.rand((), generator=generator, device=dev) * (h - s))
        in_span = (rows >= vh) & (rows < vh + s)
        masks.append((in_span[:, None] & in_span[None, :]).float())
        signs.append(torch.sign(
            2.0 * torch.rand((1, 1, 1, c), generator=generator, device=dev) - 1.0))
    if n_queries == 1:
        return stripes, masks[0], signs[0]
    return stripes, torch.stack(masks), torch.stack(signs)


def draw_squares(source, shape, n_queries: int):
    """The draws of one forward from a square source, `source(shape)` for
    one query (every source takes that), `source(shape, n_queries=n)` for
    more."""
    return source(shape) if n_queries == 1 else source(shape, n_queries=n_queries)


def kernel_layout(draws, epsilon: float, dtype=torch.float32):
    """One query's JAX-layout draws -> (stripes (B, C, 1, W), sq_delta
    (1, C, H, W)) with sq_delta = 2 eps sign mask, the operands of the fused
    front-end."""
    stripes, mask, sign = draws
    stripes_k = stripes.permute(0, 3, 1, 2).to(dtype).contiguous()
    sq_delta = (2.0 * epsilon * sign.permute(0, 3, 1, 2)
                * mask[None, None]).to(dtype).contiguous()
    return stripes_k, sq_delta


def query_layout(draws, epsilon: float, dtype=torch.float32):
    """JAX-layout draws of any number of queries -> (stripes (B, C, 1, W),
    [sq_delta (1, C, H, W) of each query])."""
    stripes, masks, signs = draws
    if masks.dim() == 2:
        masks, signs = masks[None], signs[None]
    deltas = [kernel_layout((stripes, m, sg), epsilon, dtype)[1]
              for m, sg in zip(masks, signs)]
    return stripes.permute(0, 3, 1, 2).to(dtype).contiguous(), deltas


def square_queries_nchw(x, stripes, sq_deltas, epsilon: float):
    """add_square on (B, C, H, W) with kernel-layout draws, one delta a
    query, in x's dtype (epsilon rounded to it, as JAX's weak typing does):
    each query's move projected to the eps-ball with minimum(maximum(.)),
    then clipped."""
    eps = weak_scalar(epsilon, x.dtype)
    t = clip01(x + eps * stripes)
    for sq_delta in sq_deltas:
        t = torch.minimum(torch.maximum(t + sq_delta, x - eps), x + eps)
        t = clip01(t)
    return t


def square_forward_nchw(x, stripes, sq_delta, epsilon: float):
    """add_square with one query on (B, C, H, W) with kernel-layout draws."""
    return square_queries_nchw(x, stripes, [sq_delta], epsilon)


def add_square(x: torch.Tensor, draws, *, epsilon: float = 0.05) -> torch.Tensor:
    """The perturbation on an NHWC batch with JAX-layout draws of any
    number of queries."""
    stripes, deltas = query_layout(draws, epsilon, x.dtype)
    return square_queries_nchw(x.permute(0, 3, 1, 2), stripes, deltas,
                               epsilon).permute(0, 2, 3, 1)
