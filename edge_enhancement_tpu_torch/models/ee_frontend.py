"""The edge-enhancement defense front-end, as
edge_enhancement_tpu/models/ee_frontend.py:

    x_hfs   = HFS(add_square(x))     (add_square only for the _square models)
    x_canny = Canny(x)               (always on the clean x)
    out     = clip(x_hfs + w * x_canny, 0, 1)

    optional: x_canny smoothed by a 3x3 Gaussian (`with_gf`)

The BPDA-3 variant (`CannyFilter_step125_1`, at most one square query) runs
on the kernels of ops/cuda/ee_fused.py, as the JAX front-end does with
`fused` on (the JAX config key `fused_canny` is not read; the port always
takes the kernels): without `with_gf` the whole front-end is the pair
K1/K2; with it, the edge map alone is the pair K3a/K3b and the square,
the HFS products, the smoothing and the clip are plain PyTorch. On a CUDA
tensor the kernels run, on a CPU tensor their plain versions. The other
Canny variants are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops.cuda.ee_fused import CannyFused, FusedConsts, ee_fused, operators
from ..ops.filters import gaussian_kernel
from ..ops.hfs import hfs_nchw
from ..ops.square import clip01, kernel_layout, square_forward_nchw
from ..ops.stencil import stencil2d_nchw


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
    if (cfg.type_canny != "CannyFilter_step125_1"
            or (cfg.square and cfg.n_queries != 1)):
        raise NotImplementedError(
            f"front-end {cfg.type_canny} square={cfg.square} "
            f"n_queries={cfg.n_queries}: only CannyFilter_step125_1 with at "
            "most one square query is ported")


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
    x = x.permute(0, 3, 1, 2).contiguous()
    if cfg.with_gf:
        return _frontend_gf(x, cfg, stripes, sq_delta).permute(0, 2, 3, 1)
    k = FusedConsts(r=int(cfg.r), eps=float(cfg.epsilon), w=float(cfg.w),
                    alpha=float(cfg.alpha), high=float(cfg.high_scaled),
                    sigma=float(cfg.sigma), square=bool(cfg.square))
    return ee_fused(x, stripes, sq_delta, k).permute(0, 2, 3, 1)


def _frontend_gf(x, cfg: EEConfig, stripes, sq_delta):
    """The front-end with the edge map smoothed, on (B, C, H, W): the JAX
    unfused composition with the edge map from the K3 pair."""
    x_in = (square_forward_nchw(x, stripes, sq_delta, float(cfg.epsilon))
            if cfg.square else x)
    ar, ai, br, bi, _ = operators(x.shape[2], x.shape[3], int(cfg.r),
                                  float(cfg.sigma), x.device)
    x_hfs = hfs_nchw(x_in, ar, ai, br, bi)
    edge = CannyFused.apply(x, float(cfg.high_scaled), float(cfg.sigma),
                            float(cfg.alpha))
    # zero padding and a fixed sigma of 1, whatever cfg.sigma is
    edge = stencil2d_nchw(edge, gaussian_kernel(3, 0.0, 1.0), "zero")
    return clip01(x_hfs + float(cfg.w) * edge)
