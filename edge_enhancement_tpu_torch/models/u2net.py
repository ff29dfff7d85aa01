"""U2-Net salient-edge detectors (full and small) and the fixed Sobel
magnitude, as edge_enhancement_tpu/models/u2net.py: RSU7..RSU4 U-blocks
(conv + BatchNorm + ReLU with dilation, ceil-mode 2x2 max pools, bilinear
upsampling to the skip's size), RSU4F (a dilation pyramid, no pooling), six
side outputs upsampled to full resolution, a 1x1 fusion conv, sigmoid
outputs. U2NET returns all seven sigmoid maps, U2NETP the fused one.

Modules carry the reference's torch names (stage1..stage6,
stage5d..stage1d, side1..side6, outconv; rebnconvin, rebnconv{k},
rebnconv{k}d; conv_s1, bn_s1), and convert.py maps flax's call-order names
onto them (U2NET_NAMES). Layout NCHW, in the parameters' dtype: a
bfloat16 input (the bf16 policy's) is promoted against the float32
parameters, as flax's Conv with no `dtype` promotes it, so the net and its
edge map compute in float32. The initialisation is
flax's default: lecun-normal kernels (truncated at 2 std), zero biases,
BatchNorm 1 / 0.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stencil import stencil2d_nchw
from .batchnorm import BatchNorm2d


class REBNConv(nn.Module):
    """3x3 conv with bias, dilation = padding = dirate, then the flax-rule
    BatchNorm (momentum 0.9, eps 1e-5) and ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with ceil_mode (JAX: -inf padding on the high
    side of odd dims)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of src to tar's spatial size with half-pixel centres
    and edge-clamped reads: jax.image.resize's "bilinear" for an upsample
    (its antialiasing acts only when it shrinks), also at ratios other than
    2 (ceil pooling gives 2 -> 3)."""
    if src.shape[2:] == tar.shape[2:]:
        return src
    return F.interpolate(src, size=tar.shape[2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """RSU-L: L-1 encoder convs (pools between), one dilated bottom conv,
    L-1 decoder convs with skip concatenations, plus the input conv."""

    def __init__(self, levels: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.levels = levels
        self.rebnconvin = REBNConv(in_ch, out_ch)
        for k in range(1, levels):
            setattr(self, f"rebnconv{k}", REBNConv(out_ch if k == 1 else mid_ch, mid_ch))
        setattr(self, f"rebnconv{levels}", REBNConv(mid_ch, mid_ch, dirate=2))
        for k in range(levels - 1, 0, -1):
            setattr(self, f"rebnconv{k}d", REBNConv(2 * mid_ch, out_ch if k == 1 else mid_ch))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc, hx = [], hxin
        for k in range(1, self.levels):
            hx = getattr(self, f"rebnconv{k}")(hx)
            enc.append(hx)
            if k < self.levels - 1:
                hx = _pool_ceil(hx)
        hx = getattr(self, f"rebnconv{self.levels}")(enc[-1])
        for k in range(self.levels - 1, 1, -1):
            hx = getattr(self, f"rebnconv{k}d")(torch.cat([hx, enc[k - 1]], 1))
            hx = _upsample_like(hx, enc[k - 2])
        return self.rebnconv1d(torch.cat([hx, enc[0]], 1)) + hxin


class RSU4F(nn.Module):
    """The dilation-pyramid RSU: rates 1, 2, 4 encode, 8 at the bottom,
    4, 2, 1 decode; no pooling."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNConv(in_ch, out_ch)
        self.rebnconv1 = REBNConv(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNConv(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNConv(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNConv(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNConv(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNConv(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNConv(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
        return self.rebnconv1d(torch.cat([hx2d, hx1], 1)) + hxin


# (kind, levels, in, mid, out) of stage1..stage6 and stage5d..stage1d
_FULL = ([("rsu", 7, 3, 32, 64), ("rsu", 6, 64, 32, 128), ("rsu", 5, 128, 64, 256),
          ("rsu", 4, 256, 128, 512), ("4f", 0, 512, 256, 512), ("4f", 0, 512, 256, 512)],
         [("4f", 0, 1024, 256, 512), ("rsu", 4, 1024, 128, 256), ("rsu", 5, 512, 64, 128),
          ("rsu", 6, 256, 32, 64), ("rsu", 7, 128, 16, 64)])
_SMALL = ([("rsu", 7, 3, 16, 64), ("rsu", 6, 64, 16, 64), ("rsu", 5, 64, 16, 64),
           ("rsu", 4, 64, 16, 64), ("4f", 0, 64, 16, 64), ("4f", 0, 64, 16, 64)],
          [("4f", 0, 128, 16, 64), ("rsu", 4, 128, 16, 64), ("rsu", 5, 128, 16, 64),
           ("rsu", 6, 128, 16, 64), ("rsu", 7, 128, 16, 64)])


def _block(kind, levels, in_ch, mid_ch, out_ch):
    return RSU(levels, in_ch, mid_ch, out_ch) if kind == "rsu" else RSU4F(in_ch, mid_ch, out_ch)


class U2Net(nn.Module):
    """U2NET (full=True: the seven sigmoid maps, fused first) or U2NETP
    (full=False: the fused map), (B, 3, H, W) -> (B, out_ch, H, W)."""

    def __init__(self, full: bool = False, out_ch: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.full = full
        enc, dec = _FULL if full else _SMALL
        for i, spec in enumerate(enc, 1):
            setattr(self, f"stage{i}", _block(*spec))
        for i, spec in zip(range(5, 0, -1), dec):
            setattr(self, f"stage{i}d", _block(*spec))
        side_in = [spec[4] for spec in reversed(dec)] + [enc[5][4]]
        for i, c in enumerate(side_in, 1):
            setattr(self, f"side{i}", nn.Conv2d(c, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's defaults: lecun-normal kernels (variance 1/fan_in after
        truncation at +-2 std), zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.outconv.weight.dtype))
        encs, hx = [], x
        for i in range(1, 7):
            hx = getattr(self, f"stage{i}")(hx)
            encs.append(hx)
            if i < 6:
                hx = _pool_ceil(hx)
        cur, decs = _upsample_like(encs[5], encs[4]), []
        for i in range(5, 0, -1):
            cur = getattr(self, f"stage{i}d")(torch.cat([cur, encs[i - 1]], 1))
            decs.append(cur)
            if i > 1:
                cur = _upsample_like(cur, encs[i - 2])
        hx5d, hx4d, hx3d, hx2d, hx1d = decs
        d1 = self.side1(hx1d)
        sides = [d1] + [_upsample_like(getattr(self, f"side{i}")(h), d1)
                        for i, h in zip(range(2, 7), (hx2d, hx3d, hx4d, hx5d, encs[5]))]
        d0 = self.outconv(torch.cat(sides, 1))
        if self.full:
            return tuple(torch.sigmoid(d) for d in [d0] + sides)
        return torch.sigmoid(d0)


def u2net_full(generator: Optional[torch.Generator] = None) -> U2Net:
    return U2Net(full=True, generator=generator)


def u2net_small(generator: Optional[torch.Generator] = None) -> U2Net:
    return U2Net(full=False, generator=generator)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Fixed-kernel Sobel gradient magnitude of a single-channel
    (B, 1, H, W) batch, zero padding."""
    v = stencil2d_nchw(img, _SOBEL_X, "zero")
    h = stencil2d_nchw(img, _SOBEL_Y, "zero")
    return torch.sqrt(v ** 2 + h ** 2)


def _rsu_names(levels: int) -> dict:
    """torch REBNConv name inside an RSU-L -> flax REBNConv index (the RSU's
    call order)."""
    m = {"rebnconvin": 0}
    m.update({f"rebnconv{k}": k for k in range(1, levels + 1)})
    m.update({f"rebnconv{k}d": 2 * levels - k for k in range(1, levels)})
    return m


def _rsu4f_names() -> dict:
    m = {"rebnconvin": 0}
    m.update({f"rebnconv{k}": k for k in range(1, 5)})
    m.update({"rebnconv3d": 5, "rebnconv2d": 6, "rebnconv1d": 7})
    return m


# torch stage -> (flax scope, {torch REBNConv name: flax REBNConv index}),
# the same for U2NET and U2NETP; side heads and outconv -> flax Conv_i
U2NET_NAMES = {
    "stage1": ("RSU_0", _rsu_names(7)), "stage2": ("RSU_1", _rsu_names(6)),
    "stage3": ("RSU_2", _rsu_names(5)), "stage4": ("RSU_3", _rsu_names(4)),
    "stage5": ("RSU4F_0", _rsu4f_names()), "stage6": ("RSU4F_1", _rsu4f_names()),
    "stage5d": ("RSU4F_2", _rsu4f_names()), "stage4d": ("RSU_4", _rsu_names(4)),
    "stage3d": ("RSU_5", _rsu_names(5)), "stage2d": ("RSU_6", _rsu_names(6)),
    "stage1d": ("RSU_7", _rsu_names(7)),
}
U2NET_HEADS = {**{f"side{i}": f"Conv_{i - 1}" for i in range(1, 7)}, "outconv": "Conv_6"}
