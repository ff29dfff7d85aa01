"""The one generator of every traffic mix: a pool of distinct uint8 image
batches (NHWC) and labels, made on the host from the run's seed, which the
window cycles through as the driver's loader hands it batches.

An image is a grid of flat blocks (`block` pixels a side, each block's
colour uniform in 0..255) with uniform noise of +-`noise` levels on every
pixel: flat regions, steps at the block borders for the Canny branch, and
fine texture for the HFS products. Labels are uniform over the classes.
The same seed gives the same pool."""

from __future__ import annotations

import numpy as np


def make_pool(seed: int, n_batches: int, batch: int, size: int, classes: int,
              block: int = 8, noise: int = 12):
    """(images uint8 (n, B, H, W, 3), labels int64 (n, B))."""
    rng = np.random.default_rng(int(seed))
    cells = -(-size // block)
    base = rng.integers(0, 256, (n_batches, batch, cells, cells, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, block, axis=2), block, axis=3)[:, :, :size, :size]
    img = img + rng.integers(-noise, noise + 1, img.shape, dtype=np.int16)
    images = np.clip(img, 0, 255).astype(np.uint8)
    labels = rng.integers(0, classes, (n_batches, batch), dtype=np.int64)
    return images, labels
