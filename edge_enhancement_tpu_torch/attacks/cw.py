"""CW-style margin attack under an L-inf constraint, as
edge_enhancement_tpu/attacks/cw.py::cw_linf (the reference's CWLinfAttack):
attack only the samples the model currently classifies right, start
uniformly in +-magnitude, ascend on -sum(relu(correct - wrong + margin))
with a fixed step of 0.00392, project onto the magnitude ball, [0, 1] and
the cumulative window around x - previous_p, and return the perturbation
beside x_adv for multi-restart use.

The reference gathers the correct samples into a smaller batch; this keeps
the whole batch and masks, as the JAX package does, so every iteration runs
the same passes whatever the data (the front-end kernels' launch counts do
not depend on it). `uniform_start` is the one random draw; tests replace it
to replay the JAX side's."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CWConfig:
    magnitude: float          # per-call L-inf radius
    max_eps: float            # cumulative L-inf budget
    max_iters: int = 20
    step_size: float = 0.00392  # fixed in the reference
    margin: float = 50.0
    num_classes: int = 10


def uniform_start(x: torch.Tensor, magnitude: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[-magnitude, magnitude) noise of x's shape."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return u * (2.0 * magnitude) - magnitude


def cw_linf(forward_fn: Callable[[torch.Tensor], torch.Tensor],
            x: torch.Tensor, y: torch.Tensor, cfg: CWConfig,
            generator: Optional[torch.Generator] = None,
            previous_p: Optional[torch.Tensor] = None,
            target: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_adv, cumulative perturbation), both detached;
    `forward_fn(x)` gives the logits (eval mode)."""
    x = x.detach()
    with torch.no_grad():
        active = forward_fn(x).argmax(dim=-1) == y
    active_b = active.view((-1,) + (1,) * (x.ndim - 1))
    mask = active.to(x.dtype)
    one_hot_y = F.one_hot(y.long(), cfg.num_classes).to(x.dtype)
    one_hot_t = (None if target is None
                 else F.one_hot(target.long(), cfg.num_classes).to(x.dtype))
    adv = torch.clamp(x + uniform_start(x, cfg.magnitude, generator), 0.0, 1.0)
    base = x if previous_p is None else x - previous_p
    max_x, min_x = base + cfg.max_eps, base - cfg.max_eps

    for _ in range(cfg.max_iters):
        adv = adv.detach().requires_grad_(True)
        logits = forward_fn(adv)
        correct = (one_hot_y * logits).sum(dim=1)
        if one_hot_t is not None:
            wrong = (one_hot_t * logits).sum(dim=1)
        else:
            wrong = ((1.0 - one_hot_y) * logits - 1e4 * one_hot_y).max(dim=1).values
        loss = -(F.relu(correct - wrong + cfg.margin) * mask).sum()
        (g,) = torch.autograd.grad(loss, [adv])
        with torch.no_grad():
            adv = adv + cfg.step_size * torch.sign(g)
            adv = torch.maximum(torch.minimum(adv, x + cfg.magnitude),
                                x - cfg.magnitude)
            adv = torch.clamp(adv, 0.0, 1.0)
            adv = torch.maximum(torch.minimum(adv, max_x), min_x)
    with torch.no_grad():
        adv = torch.clamp(adv.detach(), 0.0, 1.0)
        now_p = adv - x
        adv_out = torch.where(active_b, adv, x)
        if previous_p is None:
            p_out = torch.where(active_b, now_p, torch.zeros_like(now_p))
        else:
            p_out = torch.where(active_b, previous_p + now_p, previous_p)
    return adv_out, p_out
