"""The edge-enhancement defense front-end, as
edge_enhancement_tpu/models/ee_frontend.py:

    x_hfs   = HFS(add_square(x))     (add_square only for the _square models)
    x_canny = Canny(x)               (always on the clean x), or a given
                                     edge map (the learned U2-NetP's)
    out     = clip(x_hfs + w * x_canny, 0, 1)

    optional: x_canny smoothed by a 3x3 Gaussian (`with_gf`)

The BPDA-3 variant (`CannyFilter_step125_1`) runs on the kernels of
ops/cuda/ee_fused.py, as the JAX front-end does with `fused` on (the JAX
config key `fused_canny` is not read; the port always takes the kernels):
with at most one square query, no smoothing and no given edge map, the
whole front-end is the pair K1/K2; otherwise the edge map alone is the pair
K3a/K3b, and the square (any number of queries), the HFS products, the
smoothing and the clip are plain PyTorch. On a CUDA tensor the kernels
run, on a CPU tensor their plain versions. The other Canny variants
(`CannyFilter`, `CannyFilter_BPDA`) are plain PyTorch (ops/canny.py). Every
branch computes in its input's dtype: float32, or bfloat16 under the bf16
policy, as the JAX front-end does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops.canny import CANNY_VARIANTS
from ..ops.cuda.ee_fused import CannyFused, FusedConsts, ee_fused, operators
from ..ops.filters import gaussian_kernel
from ..ops.hfs import hfs_nchw
from ..ops.square import (clip01, draw_squares, kernel_layout, query_layout,
                          square_queries_nchw)
from ..ops.stencil import stencil2d_nchw, weak_scalar

STEP125 = "CannyFilter_step125_1"


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
    def low_scaled(self) -> float:
        return self.low / 255.0

    @property
    def high_scaled(self) -> float:
        return self.high / 255.0


def check_ported(cfg: EEConfig) -> None:
    """Raise for a Canny variant the front-end does not know."""
    if cfg.type_canny not in (*CANNY_VARIANTS, STEP125, "u2netp"):
        raise NotImplementedError(f"front-end {cfg.type_canny}: unknown Canny variant")


def ee_frontend(x: torch.Tensor, cfg: EEConfig,
                square_source: Optional[Callable] = None,
                edge_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the front-end to an NHWC batch in [0, 1] (float32, or bfloat16
    under the bf16 policy). `square_source(shape)` returns the square draws
    in the JAX layout (ops/square.add_square_draws; with n_queries > 1 it is
    called as `square_source(shape, n_queries=n)`); required when
    cfg.square. `edge_map` (B, H, W, 1) replaces the Canny branch."""
    check_ported(cfg)
    draws = None
    if cfg.square:
        if square_source is None:
            raise ValueError("EEConfig.square=True requires a square draw source")
        draws = draw_squares(square_source, x.shape, int(cfg.n_queries))
    if (cfg.type_canny == STEP125 and not cfg.with_gf and edge_map is None
            and (not cfg.square or cfg.n_queries == 1)):
        stripes = sq_delta = None
        if cfg.square:
            stripes, sq_delta = kernel_layout(draws, cfg.epsilon, x.dtype)
        k = FusedConsts(r=int(cfg.r), eps=float(cfg.epsilon), w=float(cfg.w),
                        alpha=float(cfg.alpha), high=float(cfg.high_scaled),
                        sigma=float(cfg.sigma), square=bool(cfg.square))
        x = x.permute(0, 3, 1, 2).contiguous()
        return ee_fused(x, stripes, sq_delta, k).permute(0, 2, 3, 1)
    if edge_map is not None:
        edge_map = edge_map.permute(0, 3, 1, 2)
    elif cfg.type_canny == "u2netp":
        raise ValueError("type_canny u2netp takes its edge map from the model's U2-NetP")
    x = x.permute(0, 3, 1, 2).contiguous()
    return _frontend_unfused(x, cfg, draws, edge_map).permute(0, 2, 3, 1)


def _frontend_unfused(x, cfg: EEConfig, draws, edge_map):
    """The JAX unfused composition on (B, C, H, W): the square of any number
    of queries, the HFS products, the edge map (given; K3a/K3b for step125;
    the plain full or BPDA Canny), its smoothing, the clip."""
    x_in = x
    if cfg.square:
        stripes, deltas = query_layout(draws, cfg.epsilon, x.dtype)
        x_in = square_queries_nchw(x, stripes, deltas, float(cfg.epsilon))
    ar, ai, br, bi, _ = operators(x.shape[2], x.shape[3], int(cfg.r),
                                  float(cfg.sigma), x.device)
    x_hfs = hfs_nchw(x_in, ar, ai, br, bi)
    if edge_map is not None:
        edge = edge_map
    elif cfg.type_canny == STEP125:
        edge = CannyFused.apply(x, float(cfg.high_scaled), float(cfg.sigma),
                                float(cfg.alpha))
    else:
        edge = CANNY_VARIANTS[cfg.type_canny](
            x, cfg.low_scaled, cfg.high_scaled, hysteresis=True,
            sigma=float(cfg.sigma), alpha=float(cfg.alpha))
    if cfg.with_gf:
        # zero padding and a fixed sigma of 1, whatever cfg.sigma is
        edge = stencil2d_nchw(edge, gaussian_kernel(3, 0.0, 1.0), "zero")
    # a float32 edge map (the U2-NetP's, under the bf16 policy too) takes w
    # in float32, and the sum promotes to float32, as in JAX
    return clip01(x_hfs + weak_scalar(float(cfg.w), edge.dtype) * edge)
