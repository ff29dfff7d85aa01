"""L-inf and L2 PGD, FGSM and random target labels, as
edge_enhancement_tpu/attacks/pgd.py: `pgd_linf` (sign steps that ascend,
or descend for a targeted attack, projection on the eps-ball and [0, 1]),
`pgd_l2` (steps along the gradient over its per-sample root-mean-square,
projection on the L2 ball of that norm), `fgsm` (one sign step, no ball
projection) and `random_targets`. Both PGDs start as `PGDConfig.random_init`
says: at x ('none'), uniform in the eps-box and clipped ('uniform'),
x + 0.001 N(0, 1) unclipped ('gaussian', the ALP/TRADES start), or the
uniform start gated by one draw for the whole batch ('trick'). The input
gradient comes from torch.autograd.grad w.r.t. x only, so the parameters
collect none.

Every random draw is one function of this module, drawn from the explicit
generator: `uniform_init_noise`, `gaussian_init_noise`, `trick_gate` (and
`random_targets` takes its offsets as an argument); tests replace them to
replay the JAX side's draws."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..parallel import mesh


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    epsilon: float
    num_steps: int
    step_size: float
    random_init: str = "uniform"   # 'none' | 'uniform' | 'gaussian' | 'trick'
    ascend: bool = True            # False for targeted attacks (descent)
    prob_start_from_clean: float = 0.0   # 'trick': P(no noise) for the batch


def uniform_init_noise(x: torch.Tensor, epsilon: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[-eps, eps) noise of x's shape."""
    u = mesh.draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device,
                                            dtype=x.dtype), x.shape)
    return u * (2.0 * epsilon) - epsilon


def gaussian_init_noise(x: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) noise of x's shape."""
    return mesh.draw_rows(lambda s: torch.randn(s, generator=generator, device=x.device,
                                                dtype=x.dtype), x.shape)


def trick_gate(x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The 'trick' start's one U[0, 1) draw for the whole batch (0-dim, on
    x's device, so no host sync)."""
    return torch.rand((), generator=generator, device=x.device, dtype=x.dtype)


def init_start(x: torch.Tensor, cfg: PGDConfig,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The attack's start point from x (detached) as cfg.random_init says."""
    if cfg.random_init == "none":
        return x
    if cfg.random_init == "uniform":
        return torch.clamp(x + uniform_init_noise(x, cfg.epsilon, generator),
                           0.0, 1.0)
    if cfg.random_init == "gaussian":
        return x + 0.001 * gaussian_init_noise(x, generator)
    if cfg.random_init == "trick":
        noise = uniform_init_noise(x, cfg.epsilon, generator)
        use = (trick_gate(x, generator) > cfg.prob_start_from_clean).to(x.dtype)
        return torch.clamp(x + use * noise, 0.0, 1.0)
    raise ValueError(f"unknown random_init {cfg.random_init!r}")


def _input_grad(loss_fn, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(x), [x])
    return g


def pgd_linf(loss_fn: Callable[[torch.Tensor], torch.Tensor],
             x_natural: torch.Tensor, cfg: PGDConfig,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Returns x_adv (detached) in [0, 1]; `loss_fn(x)` is the scalar the
    attack ascends (descends when not cfg.ascend)."""
    x_natural = x_natural.detach()
    x = init_start(x_natural, cfg, generator)
    lo, hi = x_natural - cfg.epsilon, x_natural + cfg.epsilon
    step = cfg.step_size if cfg.ascend else -cfg.step_size
    for _ in range(cfg.num_steps):
        g = _input_grad(loss_fn, x)
        with torch.no_grad():
            x = x + step * torch.sign(g)
            x = torch.minimum(torch.maximum(x, lo), hi)
            x = torch.clamp(x, 0.0, 1.0)
    return x.detach()


def _batch_l2_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean of squares) per sample: the reference's l2_norm takes the
    mean, not the sum."""
    return torch.sqrt(torch.mean(x.reshape(x.shape[0], -1) ** 2, dim=1))


def pgd_l2(loss_fn: Callable[[torch.Tensor], torch.Tensor],
           x_natural: torch.Tensor, cfg: PGDConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """L2 PGD with root-mean-square-normalised steps, always ascending (the
    JAX pgd_l2 ignores cfg.ascend). Returns x_adv (detached) in [0, 1]."""
    x_natural = x_natural.detach()
    x = init_start(x_natural, cfg, generator)
    expand = (slice(None),) + (None,) * (x_natural.ndim - 1)
    for _ in range(cfg.num_steps):
        g = _input_grad(loss_fn, x)
        with torch.no_grad():
            g = g / (_batch_l2_norm(g)[expand] + 1e-8)
            delta = x + cfg.step_size * g - x_natural
            norm = _batch_l2_norm(delta)
            scale = torch.where(norm > cfg.epsilon,
                                cfg.epsilon / torch.clamp(norm, min=1e-12),
                                torch.ones_like(norm))
            x = torch.clamp(x_natural + delta * scale[expand], 0.0, 1.0)
    return x.detach()


def fgsm(loss_fn: Callable[[torch.Tensor], torch.Tensor],
         x_natural: torch.Tensor, step_size: float = 0.007,
         targeted: bool = False) -> torch.Tensor:
    """One sign step of `loss_fn`'s gradient (against it when targeted),
    clamped to [0, 1], no ball projection."""
    g = _input_grad(loss_fn, x_natural)
    step = -step_size if targeted else step_size
    with torch.no_grad():
        return torch.clamp(x_natural.detach() + step * torch.sign(g), 0.0, 1.0)


def random_targets(labels: torch.Tensor, num_classes: int,
                   generator: Optional[torch.Generator] = None,
                   offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniformly random wrong labels, (y + U{1..n-1}) mod n; `offset`
    replaces the draw."""
    if offset is None:
        offset = mesh.draw_rows(lambda s: torch.randint(
            1, num_classes, s, generator=generator, device=labels.device), labels.shape)
    return torch.remainder(labels.long() + offset.to(labels.device).long(),
                           num_classes)
