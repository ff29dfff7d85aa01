"""Per-epoch learning-rate schedules the driver reads, as
edge_enhancement_tpu/train/schedules.py."""

from __future__ import annotations


def step30(init_lr: float, epoch: int) -> float:
    """0.1x every 30 epochs (the ImageNet recipe)."""
    return init_lr * (0.1 ** (epoch // 30))


def piecewise_50_75(init_lr: float, epoch: int, total_epochs: int) -> float:
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
