"""A plain ResNet-18 behind the edge-enhancement front-end, for the
benchmark's reference: torchvision's module names (conv1, bn1,
layer1.0.conv1, downsample.0/1, fc), BatchNorm with flax's rule (the
running variance moves toward the biased batch variance, momentum 0.9 in
flax's sense, eps 1e-5), NHWC input in [0, 1], float32 throughout (the
caller turns TF32 off, or on for the TF32 control).

Written from the architecture (He et al. 2016, the reference
repository's models) and imports nothing of the program.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from .frontend import frontend, square_draws

STAGES = (2, 2, 2, 2)


class BatchNorm(nn.Module):
    def __init__(self, n: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        dtype = x.dtype
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(dtype)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.stride, self.padding = stride, k // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


class Block(nn.Module):
    """The basic block: two 3x3 convolutions, a 1x1 downsample where the
    shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.ModuleList([Conv(inplanes, planes, 1, stride),
                                             BatchNorm(planes)])

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        res = x if self.downsample is None else self.downsample[1](self.downsample[0](x))
        return F.relu(out + res)


class ResNet(nn.Module):
    """ResNet-18; `ee` is the front-end's settings (frontend.frontend);
    `generator` gives the square's draws, one set a forward, when
    ee['square']."""

    def __init__(self, depth: int, num_classes: int, ee: dict,
                 generator: torch.Generator = None):
        super().__init__()
        if depth != 18:
            raise NotImplementedError(f"the reference has no ResNet-{depth}")
        self.ee, self.generator = ee, generator
        self.conv1 = Conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for g, (planes, n) in enumerate(zip((64, 128, 256, 512), STAGES)):
            blocks = []
            for i in range(n):
                blocks.append(Block(inplanes, planes, (1 if g == 0 else 2) if i == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{g + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x):
        draws = square_draws(x.shape, self.generator) if self.ee["square"] else None
        x = frontend(x, self.ee, draws).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), kernel_size=3, stride=2, padding=1)
        for g in range(1, 5):
            for block in getattr(self, f"layer{g}"):
                x = block(x)
        return F.linear(x.mean(dim=(2, 3)), self.fc.weight) + self.fc.bias


def model_config(cfg: dict) -> dict:
    """The reference's model settings from a configuration file's keys
    (the recipe's YAML values): depth, classes, precision and front-end."""
    m = re.fullmatch(r"resnet(18)_EE(_square)?", cfg["arch"])
    if m is None or cfg.get("type_canny") != "CannyFilter_step125_1" or cfg.get("gf") \
            or int(cfg.get("n_queries", 1)) != 1 or cfg.get("half"):
        raise NotImplementedError(f"the reference has no model for {cfg['arch']} with "
                                  f"{cfg.get('type_canny')}, gf {cfg.get('gf')}, "
                                  f"half {cfg.get('half')}")
    return {"depth": int(m.group(1)), "num_classes": int(cfg["num_classes"]),
            "precision": "float32",
            "ee": {"r": int(cfg["r"]), "w": float(cfg["w"]), "high": float(cfg["high"]),
                   "sigma": float(cfg["sigma"]), "alpha": float(cfg["alpha"]),
                   "epsilon": float(cfg["epsilon"]), "square": m.group(2) is not None}}
