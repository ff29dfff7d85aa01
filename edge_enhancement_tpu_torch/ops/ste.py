"""Straight-through estimator of the Canny threshold, as
edge_enhancement_tpu/ops/ste.py::to_compare: forward 1[x > t], backward
passes the gradient where t < x <= 1.001."""

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
