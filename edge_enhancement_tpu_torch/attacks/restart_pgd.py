"""Multi-restart PGD with early stopping, and the mixup helpers, as
edge_enhancement_tpu/attacks/restart_pgd.py (the AWP drivers' local
`attack_pgd`, `mixup_data`, `mixup_criterion` and `normalize`).

For each restart: start uniformly in the eps-box (l_inf) or from a
Gaussian draw projected on the eps-ball (l_2), take `attack_iters`
sign or normalised steps, where samples already misclassified stop moving
(early stop), and keep per sample the delta of the restart with the
highest final cross-entropy. Inputs are NHWC, as the port's models take
them.

The draws are functions of this module on the explicit generator
(`delta_draw`, `mixup_draws`); tests replace them to replay the JAX
side's. A forward is `forward_fn(x, draws)` with `draws = draw(x)`, as in
attacks/autoattack.py: an attack iteration's early-stop logits and its
gradient come from one forward, because JAX takes them under one key."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .autoattack import DrawFn, ForwardFn, no_draws
from .pgd import gaussian_init_noise, uniform_init_noise


@dataclasses.dataclass(frozen=True)
class RestartPGDConfig:
    epsilon: float
    alpha: float                 # step size
    attack_iters: int = 10
    restarts: int = 1
    norm: str = "l_inf"          # l_inf | l_2
    early_stop: bool = True


def _per_sample_ce(logits, y):
    return -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]


def _sample_norm(d: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(d.reshape(d.shape[0], -1), dim=1)
    return n.view((-1,) + (1,) * (d.ndim - 1))


def _l2_normalize(g):
    return g / torch.clamp(_sample_norm(g), min=1e-10)


def _project_l2(d, eps):
    return d * torch.clamp(eps / torch.clamp(_sample_norm(d), min=1e-10), max=1.0)


def delta_draw(x: torch.Tensor, cfg: RestartPGDConfig,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One restart's start draw: U[-eps, eps) (l_inf) or N(0, 1) (l_2)."""
    if cfg.norm == "l_inf":
        return uniform_init_noise(x, cfg.epsilon, generator)
    return gaussian_init_noise(x, generator)


def attack_pgd(forward_fn: ForwardFn, x: torch.Tensor, y: torch.Tensor,
               cfg: RestartPGDConfig, generator: Optional[torch.Generator] = None,
               draw: DrawFn = no_draws) -> torch.Tensor:
    """Returns the best delta over the restarts (detached); the caller
    forms clamp(x + delta), as the reference does."""
    x, y = x.detach(), y.long()
    expand = (-1,) + (1,) * (x.ndim - 1)
    max_delta = torch.zeros_like(x)
    max_loss = torch.full((x.shape[0],), -float("inf"), device=x.device,
                          dtype=x.dtype)
    for _ in range(cfg.restarts):
        delta = delta_draw(x, cfg, generator)
        if cfg.norm != "l_inf":
            delta = _project_l2(delta, cfg.epsilon)
        delta = torch.clamp(x + delta, 0.0, 1.0) - x
        for _ in range(cfg.attack_iters):
            d = delta.detach().requires_grad_(True)
            logits = forward_fn(x + d, draw(x))
            (g,) = torch.autograd.grad(_per_sample_ce(logits, y).sum(), [d])
            with torch.no_grad():
                if cfg.norm == "l_inf":
                    d_new = torch.clamp(delta + cfg.alpha * torch.sign(g),
                                        -cfg.epsilon, cfg.epsilon)
                else:
                    d_new = _project_l2(delta + cfg.alpha * _l2_normalize(g),
                                        cfg.epsilon)
                d_new = torch.clamp(x + d_new, 0.0, 1.0) - x
                if cfg.early_stop:
                    correct = logits.argmax(dim=-1) == y
                    d_new = torch.where(correct.view(expand), d_new, delta)
                delta = d_new
        with torch.no_grad():
            loss = _per_sample_ce(forward_fn(x + delta, draw(x)), y)
            better = loss > max_loss
            max_delta = torch.where(better.view(expand), delta, max_delta)
            max_loss = torch.maximum(loss, max_loss)
    return max_delta


def mixup_draws(n: int, alpha: float, generator: Optional[torch.Generator],
                device=None):
    """(lam, permutation of n): lam ~ Beta(alpha, alpha) as a Python float
    (1.0 when alpha <= 0), from a numpy generator seeded by one draw of
    `generator` (torch's Beta takes no generator), and the permutation on
    `device` from `generator`."""
    lam = 1.0
    if alpha > 0:
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=None if generator is None else generator.device))
        lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    return lam, torch.randperm(n, generator=generator, device=device)


def mixup_data(x: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator] = None, alpha: float = 1.0):
    """(mixed_x, y_a, y_b, lam): lam x + (1 - lam) x[perm]."""
    lam, idx = mixup_draws(x.shape[0], alpha, generator, x.device)
    mixed = lam * x + (1.0 - lam) * x[idx]
    return mixed, y, y[idx], lam


def mixup_criterion(loss_fn: Callable, pred, y_a, y_b, lam):
    """lam * loss(pred, y_a) + (1 - lam) * loss(pred, y_b)."""
    return lam * loss_fn(pred, y_a) + (1.0 - lam) * loss_fn(pred, y_b)


CIFAR100_MEAN = (0.5070751592371323, 0.48654887331495095, 0.4409178433670343)
CIFAR100_STD = (0.2673342858792401, 0.2564384629170883, 0.27615047132568404)


def normalize(x: torch.Tensor, mean=CIFAR100_MEAN, std=CIFAR100_STD) -> torch.Tensor:
    """Per-channel (x - mean) / std on an NHWC batch. As in the reference,
    the shipped training paths do not normalise (pixels stay in [0, 1])."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    return (x - mean) / std
