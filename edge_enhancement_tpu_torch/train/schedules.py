"""Learning-rate schedules the driver reads, as
edge_enhancement_tpu/train/schedules.py: per-epoch ones, and the fast-AT
knots evaluated every minibatch."""

from __future__ import annotations

import math

import numpy as np


def step30(init_lr: float, epoch: int) -> float:
    """0.1x every 30 epochs (the ImageNet recipe)."""
    return init_lr * (0.1 ** (epoch // 30))


def step30_free(init_lr: float, epoch: int, n_repeats: int) -> float:
    """Free-AT: the 30-epoch boundary divided by the replay count."""
    return init_lr * (0.1 ** (epoch // int(math.ceil(30.0 / n_repeats))))


def piecewise_50_75(init_lr: float, epoch: float, total_epochs: int) -> float:
    """0.1x after 50% and after 75% of training (strict >, as the
    reference)."""
    if epoch > total_epochs * 0.75:
        return init_lr * 0.01
    if epoch > total_epochs * 0.5:
        return init_lr * 0.1
    return init_lr


def multistep(init_lr: float, epoch: int, milestones=(50, 80), gamma: float = 0.1) -> float:
    """torch MultiStepLR semantics (the MNIST recipe)."""
    k = sum(1 for m in milestones if epoch >= m)
    return init_lr * (gamma ** k)


def cyclic_interp(lr_min: float, lr_max: float, step: int, total_steps: int) -> float:
    """Symmetric triangular interpolation over `total_steps`."""
    return float(np.interp([step], [0, total_steps * 0.5, total_steps],
                           [lr_min, lr_max, lr_min])[0])


def interp_knots(epoch_float: float, lr_epochs, lr_values) -> float:
    """Fast-AT: np.interp over absolute-epoch knots at epoch + the
    minibatch's fraction (knots like [0, 1, 6] -> [0, 0.4, 0.04])."""
    return float(np.interp([epoch_float], list(lr_epochs), list(lr_values))[0])
