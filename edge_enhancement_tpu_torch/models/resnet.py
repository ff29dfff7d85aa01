"""ResNet-18 with the edge-enhancement front-end, as
edge_enhancement_tpu/models/resnet.py (`ResNet` with `BasicBlock`).

Modules carry torchvision's names (conv1, bn1, layer1.0.conv1, ..., fc), so
convert.state_dict_from_jax maps the JAX parameters straight in. The stem is
a plain 7x7 stride-2 convolution: the JAX `StemConv` is a space-to-depth
rewrite of the same parameter for the TPU's layout.

Input is NHWC in [0, 1], as in the JAX model; the convolutions run NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import max_pool_3x3_s2
from .ee_frontend import EEConfig, check_ported, ee_frontend


class BatchNorm2d(nn.Module):
    """BatchNorm with flax's running-statistics rule: running_var moves
    toward the BIASED batch variance (torch's own BatchNorm uses the
    unbiased one). Momentum 0.9 in flax's sense (torch 0.1), eps 1e-5."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride),
                                            BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Plain / EE / EE_square ResNet with BasicBlocks. `square_source(shape)`
    supplies the square draws of the EE_square front-end."""

    def __init__(self, layers=(2, 2, 2, 2), num_classes: int = 200,
                 ee: Optional[EEConfig] = None,
                 square_source: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ee is not None:
            check_ported(ee)
        self.ee, self.square_source = ee, square_source
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for g, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if g == 0 else 2
            group = [BasicBlock(inplanes, planes, stride)]
            group += [BasicBlock(planes, planes) for _ in range(blocks - 1)]
            inplanes = planes
            setattr(self, f"layer{g + 1}", nn.Sequential(*group))
        self.fc = nn.Linear(512, num_classes)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: conv N(0, 2/fan_out), BN 1/0, Dense
        lecun-normal (truncated at 2 std) with a zero bias."""
        for m in self.modules():
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

    def forward(self, x):
        """x: NHWC float32 in [0, 1] -> logits (B, num_classes)."""
        if self.ee is not None:
            x = ee_frontend(x, self.ee, self.square_source)
        x = x.permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))


_LAYOUTS = {18: (2, 2, 2, 2)}


def resnet(depth: int, num_classes: int = 200, ee: Optional[EEConfig] = None,
           square_source: Optional[Callable] = None,
           generator: Optional[torch.Generator] = None) -> ResNet:
    if depth not in _LAYOUTS:
        raise NotImplementedError(
            f"resnet depth {depth}; ported: {sorted(_LAYOUTS)}")
    return ResNet(_LAYOUTS[depth], num_classes=num_classes, ee=ee,
                  square_source=square_source, generator=generator)
