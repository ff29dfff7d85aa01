"""The edge-enhancement defense front-end, as
edge_enhancement_tpu/models/ee_frontend.py:

    x_hfs   = HFS(add_square(x))     (add_square only for the _square models)
    x_canny = Canny(x)               (always on the clean x)
    out     = clip(x_hfs + w * x_canny, 0, 1)

The BPDA-3 variant (`CannyFilter_step125_1`, no Gaussian smoothing of the
edge map, at most one square query) always runs as the fused kernel pair
of ops/cuda/ee_fused.py (the JAX config key `fused_canny` is not read): on
a CUDA tensor it is the kernel, on a CPU tensor its plain version. The
other Canny variants are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops.cuda.ee_fused import FusedConsts, ee_fused
from ..ops.square import kernel_layout


@dataclasses.dataclass(frozen=True)
class EEConfig:
    """Static hyperparameters of the defense front-end (from the YAML configs)."""
    r: int = 8                      # HFS low-pass radius
    w: float = 1.0                  # edge-map weight
    with_gf: bool = False           # Gaussian-smooth the edge map
    low: float = 60.0               # low threshold, in /255 units
    high: float = 120.0             # high threshold, in /255 units
    alpha: float = 0.0              # magnitude mask threshold
    sigma: float = 1.0              # Gaussian blur sigma
    type_canny: str = "CannyFilter"
    square: bool = False
    epsilon: float = 0.05
    n_queries: int = 5000

    @property
    def high_scaled(self) -> float:
        return self.high / 255.0


def check_ported(cfg: EEConfig) -> None:
    """Raise for the front-end variants this package does not run yet."""
    if (cfg.type_canny != "CannyFilter_step125_1" or cfg.with_gf
            or (cfg.square and cfg.n_queries != 1)):
        raise NotImplementedError(
            f"front-end {cfg.type_canny} with_gf={cfg.with_gf} "
            f"square={cfg.square} n_queries={cfg.n_queries}: only "
            "CannyFilter_step125_1 without gf and with at most one square "
            "query is ported")


def ee_frontend(x: torch.Tensor, cfg: EEConfig,
                square_source: Optional[Callable] = None) -> torch.Tensor:
    """Apply the front-end to an NHWC float32 batch in [0, 1].
    `square_source(shape)` returns the square draws in the JAX layout
    (ops/square.add_square_draws); required when cfg.square."""
    check_ported(cfg)
    stripes = sq_delta = None
    if cfg.square:
        if square_source is None:
            raise ValueError("EEConfig.square=True requires a square draw source")
        stripes, sq_delta = kernel_layout(square_source(x.shape), cfg.epsilon,
                                          x.dtype)
    k = FusedConsts(r=int(cfg.r), eps=float(cfg.epsilon), w=float(cfg.w),
                    alpha=float(cfg.alpha), high=float(cfg.high_scaled),
                    sigma=float(cfg.sigma), square=bool(cfg.square))
    out = ee_fused(x.permute(0, 3, 1, 2).contiguous(), stripes, sq_delta, k)
    return out.permute(0, 2, 3, 1)
