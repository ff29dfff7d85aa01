"""ResNet-18/34/50/101/152 with the edge-enhancement front-end, as
edge_enhancement_tpu/models/resnet.py (`ResNet` with `BasicBlock` or
`Bottleneck`; the stride of a Bottleneck sits on its 3x3 convolution).

Modules carry torchvision's names (conv1, bn1, layer1.0.conv1, ...,
downsample.0/1, fc), so convert.state_dict_from_jax maps the JAX parameters
straight in. The stem is a plain 7x7 stride-2 convolution: the JAX
`StemConv` is a space-to-depth rewrite of the same parameter for the TPU's
layout.

The dtype policy is the JAX model's `dtype` field: with bfloat16 the input
is cast to bfloat16 before the front-end, the convolutions and the final
Dense compute in bfloat16 from float32 parameters cast at use, BatchNorm
keeps float32 parameters and running statistics and computes as flax's
`nn.BatchNorm(dtype=bf16)` does, and the logits come back as float32. The
casts are written out: torch.autocast's per-op policy is not JAX's.

Input is NHWC in [0, 1], as in the JAX model; the convolutions run NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import max_pool_3x3_s2
from .batchnorm import BatchNorm2d
from .ee_frontend import EEConfig, check_ported, ee_frontend
from .u2net import U2Net


class Conv2d(nn.Conv2d):
    """A convolution in its input's dtype, the float32 weight cast at use."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Linear(nn.Linear):
    """flax's Dense in its input's dtype: x W^T rounded, then + b rounded."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _projection(inplanes: int, planes: int, stride: int):
    """The shortcut's 1x1 convolution and BatchNorm where the shape changes."""
    if stride == 1 and inplanes == planes:
        return None
    return nn.Sequential(_conv(inplanes, planes, 1, stride), BatchNorm2d(planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _projection(inplanes, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (the stride), 1x1 expand to 4 planes."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = _projection(inplanes, planes * 4, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Plain / EE / EE_square ResNet. `square_source(shape)` supplies the
    square draws of the EE_square front-end; `dtype` (None or
    torch.bfloat16) is the compute dtype of the policy above."""

    def __init__(self, block=BasicBlock, layers=(2, 2, 2, 2),
                 num_classes: int = 200, ee: Optional[EEConfig] = None,
                 square_source: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if ee is not None:
            check_ported(ee, dtype)
        self.ee, self.square_source, self.dtype = ee, square_source, dtype
        # the learned edge map of type_canny u2netp: a U2-NetP on the input,
        # in the backbone's mode (train mode moves its statistics too)
        self.u2net = (U2Net(full=False, generator=generator)
                      if ee is not None and ee.type_canny == "u2netp" else None)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for g, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if g == 0 else 2
            group = [block(inplanes, planes, stride)]
            inplanes = planes * block.expansion
            group += [block(inplanes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{g + 1}", nn.Sequential(*group))
        self.fc = Linear(inplanes, num_classes)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: conv N(0, 2/fan_out), BN 1/0, Dense
        lecun-normal (truncated at 2 std) with a zero bias. The U2-NetP
        keeps its own (U2Net.init_weights)."""
        edge_net = set(self.u2net.modules()) if self.u2net is not None else set()
        for m in (m for m in self.modules() if m not in edge_net):
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            elif isinstance(m, nn.Linear):
                # variance 1/fan_in after truncation at +-2 std
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()

    def forward(self, x, square_draws=None):
        """x: NHWC float32 in [0, 1] -> float32 logits (B, num_classes).
        `square_draws` replaces the square source's fresh draw."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.ee is not None:
            source = (self.square_source if square_draws is None
                      else lambda shape, **_: square_draws)
            edge = (None if self.u2net is None
                    else self.u2net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
            x = ee_frontend(x, self.ee, source, edge_map=edge)
        x = x.permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # jnp.mean sums a low-precision array in float32 and rounds once
        x = x.float().mean(dim=(2, 3)).to(x.dtype)
        return self.fc(x).float()


_LAYOUTS = {18: (BasicBlock, (2, 2, 2, 2)), 34: (BasicBlock, (3, 4, 6, 3)),
            50: (Bottleneck, (3, 4, 6, 3)), 101: (Bottleneck, (3, 4, 23, 3)),
            152: (Bottleneck, (3, 8, 36, 3))}


def resnet(depth: int, num_classes: int = 200, ee: Optional[EEConfig] = None,
           square_source: Optional[Callable] = None,
           generator: Optional[torch.Generator] = None,
           dtype: Optional[torch.dtype] = None) -> ResNet:
    if depth not in _LAYOUTS:
        raise NotImplementedError(
            f"resnet depth {depth}; ported: {sorted(_LAYOUTS)}")
    block, layers = _LAYOUTS[depth]
    return ResNet(block, layers, num_classes=num_classes, ee=ee,
                  square_source=square_source, generator=generator, dtype=dtype)
