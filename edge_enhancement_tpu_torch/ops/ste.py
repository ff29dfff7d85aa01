"""Straight-through estimators of the Canny thresholds, as
edge_enhancement_tpu/ops/ste.py:

* `binary_connect`: forward sign(x) with sign(0) := -1; backward passes the
  gradient where |x| <= 1.001.
* `to_compare`: forward 1[x > t]; backward passes the gradient where
  t < x <= 1.001.
* `to_eq`: forward 1[x == 0.5]; backward passes the gradient where
  x == 0.5.
"""

from __future__ import annotations

import torch


class _ToCompare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, threshold):
        ctx.save_for_backward(x)
        ctx.threshold = threshold
        return (x > threshold).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x > ctx.threshold) & (x <= 1.001)
        return torch.where(keep, g, torch.zeros_like(g)), None


def to_compare(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return _ToCompare.apply(x, float(threshold))


def safe_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with zeros mapped to -1."""
    s = torch.sign(x)
    return torch.where(s == 0, -torch.ones_like(s), s)


class _BinaryConnect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return safe_sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x.abs() > 1.001, torch.zeros_like(g), g)


def binary_connect(x: torch.Tensor) -> torch.Tensor:
    return _BinaryConnect.apply(x)


class _ToEq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x == 0.5).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x == 0.5, g, torch.zeros_like(g))


def to_eq(x: torch.Tensor) -> torch.Tensor:
    return _ToEq.apply(x)
