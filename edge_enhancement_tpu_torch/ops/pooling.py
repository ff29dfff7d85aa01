"""3x3 stride-2 pad-1 max pool. torch's backward routes each window's
gradient to the FIRST maximal element in row-major order, the convention
edge_enhancement_tpu/ops/pooling.py pins; the front-end's saturated plateaus
make ties common."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """Pool over a (B, C, H, W) tensor."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
