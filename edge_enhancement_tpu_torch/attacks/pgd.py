"""L-inf PGD, FGSM and random target labels, as
edge_enhancement_tpu/attacks/pgd.py: `pgd_linf` (random or clean start,
sign steps that ascend, or descend for a targeted attack, projection on the
eps-ball and [0, 1]), `fgsm` (one sign step, no ball projection) and
`random_targets`. The input gradient comes from torch.autograd.grad w.r.t.
x only, so the parameters collect none. `uniform_init_noise` is PGD's one
random draw and `random_targets` takes its offsets as an argument; tests
replace them to replay the JAX side's draws."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    epsilon: float
    num_steps: int
    step_size: float
    random_init: str = "uniform"   # 'none' | 'uniform' (U[-eps, eps])
    ascend: bool = True            # False for targeted attacks (descent)


def uniform_init_noise(x: torch.Tensor, epsilon: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[-eps, eps) noise of x's shape."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return u * (2.0 * epsilon) - epsilon


def pgd_linf(loss_fn: Callable[[torch.Tensor], torch.Tensor],
             x_natural: torch.Tensor, cfg: PGDConfig,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Returns x_adv (detached) in [0, 1]; `loss_fn(x)` is the scalar the
    attack ascends (descends when not cfg.ascend)."""
    x_natural = x_natural.detach()
    if cfg.random_init == "uniform":
        noise = uniform_init_noise(x_natural, cfg.epsilon, generator)
        x = torch.clamp(x_natural + noise, 0.0, 1.0)
    elif cfg.random_init == "none":
        x = x_natural
    else:
        raise NotImplementedError(f"random_init {cfg.random_init!r}")
    lo, hi = x_natural - cfg.epsilon, x_natural + cfg.epsilon
    step = cfg.step_size if cfg.ascend else -cfg.step_size
    for _ in range(cfg.num_steps):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), [x])
        with torch.no_grad():
            x = x + step * torch.sign(g)
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = torch.clamp(x, 0.0, 1.0)
    return x.detach()


def fgsm(loss_fn: Callable[[torch.Tensor], torch.Tensor],
         x_natural: torch.Tensor, step_size: float = 0.007,
         targeted: bool = False) -> torch.Tensor:
    """One sign step of `loss_fn`'s gradient (against it when targeted),
    clamped to [0, 1], no ball projection."""
    x = x_natural.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(x), [x])
    step = -step_size if targeted else step_size
    with torch.no_grad():
        return torch.clamp(x_natural.detach() + step * torch.sign(g), 0.0, 1.0)


def random_targets(labels: torch.Tensor, num_classes: int,
                   generator: Optional[torch.Generator] = None,
                   offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniformly random wrong labels, (y + U{1..n-1}) mod n; `offset`
    replaces the draw."""
    if offset is None:
        offset = torch.randint(1, num_classes, labels.shape, generator=generator,
                               device=labels.device)
    return torch.remainder(labels.long() + offset.to(labels.device).long(),
                           num_classes)
