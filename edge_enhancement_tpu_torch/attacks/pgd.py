"""L-inf PGD, as edge_enhancement_tpu/attacks/pgd.py::pgd_linf: random or
clean start, sign steps, projection on the eps-ball and [0, 1]. The input
gradient comes from torch.autograd.grad w.r.t. x only, so the parameters
collect none. `uniform_init_noise` is the one random draw; tests replace it
to replay the JAX side's noise."""

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


def uniform_init_noise(x: torch.Tensor, epsilon: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[-eps, eps) noise of x's shape."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return u * (2.0 * epsilon) - epsilon


def pgd_linf(loss_fn: Callable[[torch.Tensor], torch.Tensor],
             x_natural: torch.Tensor, cfg: PGDConfig,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Returns x_adv (detached) in [0, 1]; `loss_fn(x)` is the scalar the
    attack ascends."""
    x_natural = x_natural.detach()
    if cfg.random_init == "uniform":
        noise = uniform_init_noise(x_natural, cfg.epsilon, generator)
        x = torch.clamp(x_natural + noise, 0.0, 1.0)
    elif cfg.random_init == "none":
        x = x_natural
    else:
        raise NotImplementedError(f"random_init {cfg.random_init!r}")
    lo, hi = x_natural - cfg.epsilon, x_natural + cfg.epsilon
    for _ in range(cfg.num_steps):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), [x])
        with torch.no_grad():
            x = x + cfg.step_size * torch.sign(g)
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = torch.clamp(x, 0.0, 1.0)
    return x.detach()
