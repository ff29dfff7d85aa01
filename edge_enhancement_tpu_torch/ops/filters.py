"""Static filter kernels (numpy), recomputed as in
edge_enhancement_tpu/ops/filters.py; tests pin them equal."""

from __future__ import annotations

import numpy as np


def gaussian_kernel(k: int = 3, mu: float = 0.0, sigma: float = 1.0,
                    normalize: bool = True) -> np.ndarray:
    """k x k Gaussian kernel on a [-1, 1]^2 grid."""
    line = np.linspace(-1, 1, k)
    x, y = np.meshgrid(line, line)
    dist = np.sqrt(x ** 2 + y ** 2)
    g = np.exp(-((dist - mu) ** 2) / (2 * sigma ** 2))
    g = g / (2 * np.pi * sigma ** 2)
    if normalize:
        g = g / g.sum()
    return g.astype(np.float32)


def sobel_kernel(k: int = 3) -> np.ndarray:
    """k x k Sobel-x kernel x / (x^2 + y^2)."""
    line = np.linspace(-(k // 2), k // 2, k)
    x, y = np.meshgrid(line, line)
    denom = x ** 2 + y ** 2
    denom[:, k // 2] = 1.0  # avoid division by zero on the centre column
    return (x / denom).astype(np.float32)


# Offsets (drow, dcol) of the -1 entry of the eight directional NMS kernels,
# for angles 0, 45, ..., 315 degrees in image coordinates (row grows
# downward; angle 0 points east, positive angles toward negative rows).
_DIRECTION_OFFSETS: tuple[tuple[int, int], ...] = (
    (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))


def direction_offsets() -> tuple[tuple[int, int], ...]:
    return _DIRECTION_OFFSETS


def hysteresis_kernel() -> np.ndarray:
    """3x3 all-1.25 kernel of the hysteresis vote."""
    return np.full((3, 3), 1.25, dtype=np.float32)
