"""ResNet-18/34/50/101/152 with the edge-enhancement front-end or the
feature-denoising blocks, and the pre-activation ResNets of the AWP
drivers, as edge_enhancement_tpu/models/resnet.py (`ResNet` with
`BasicBlock` or `Bottleneck`, the stride of a Bottleneck on its 3x3
convolution; `PreActResNet` with `PreActBlock` or `PreActBottleneck`).

Modules carry torchvision's names (conv1, bn1, layer1.0.conv1, ...,
downsample.0/1, fc; the denoising blocks denoise1..4.conv3/bn) and the AWP
reference's for the PreActResNets (conv1, bn1 on the 7x7 stem only,
layer1.0.bn1/conv1/bn2/conv2/shortcut.0, bn, and the head `linear` on the
CIFAR stem, `fc` on the others), so convert.py maps the JAX parameters
straight in. The stem is a plain 7x7 stride-2 convolution: the JAX
`StemConv` is a space-to-depth rewrite of the same parameter for the TPU's
layout.

The dtype policy is the JAX model's `dtype` field: with bfloat16 the input
is cast to bfloat16 before the front-end, the convolutions and the final
Dense compute in bfloat16 from float32 parameters cast at use, BatchNorm
keeps float32 parameters and running statistics and computes as flax's
`nn.BatchNorm(dtype=bf16)` does, and the logits come back as float32. The
casts are written out: torch.autocast's per-op policy is not JAX's. Where
JAX hands a float32 tensor on (the U2-NetP's front-end output, a denoising
block's output), the port does too, and rounds where the next JAX module
with the policy's dtype rounds (the stem's BatchNorm, the next layer
group's convolutions, the head).

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


def _global_mean(x):
    """The spatial mean of (B, C, H, W), as jnp.mean: a low-precision array
    summed in float32 and rounded once."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3)).to(x.dtype)


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


class DenoisingBlock(nn.Module):
    """Non-local means denoising, the dot-product form (the reference's
    embed=False, softmax=False): f = x Gram(x, x) / (H W), both products
    summed in float32, then cast to x's dtype, a 1x1 convolution with a
    bias, BatchNorm, and x + f. The reference's embedding convolutions
    (conv1, conv2) take no part in that form and are not kept. As in JAX
    the convolution and BatchNorm carry no dtype: a bfloat16 f is promoted
    against their float32 parameters, and the block returns x + f in
    float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv3 = nn.Conv2d(channels, channels, 1)
        self.bn = BatchNorm2d(channels)

    def forward(self, x):
        b, c, h, w = x.shape
        v = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(b, c, h * w)
        gram = torch.bmm(v, v.transpose(1, 2))
        f = (torch.bmm(gram.transpose(1, 2), v) / (h * w)).to(x.dtype).reshape(b, c, h, w)
        f = f.to(torch.promote_types(f.dtype, self.conv3.weight.dtype))
        return x + self.bn(self.conv3(f))


class ResNet(nn.Module):
    """Plain / EE / EE_square / feature-denoising ResNet. `square_source(shape)`
    supplies the square draws of the EE_square front-end; `denoise` puts a
    DenoisingBlock after each layer group; `dtype` (None or torch.bfloat16)
    is the compute dtype of the policy above."""

    def __init__(self, block=BasicBlock, layers=(2, 2, 2, 2),
                 num_classes: int = 200, ee: Optional[EEConfig] = None,
                 square_source: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, denoise: bool = False):
        super().__init__()
        if ee is not None:
            check_ported(ee)
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
            if denoise:
                setattr(self, f"denoise{g + 1}", DenoisingBlock(inplanes))
        self.denoise = denoise
        self.fc = Linear(inplanes, num_classes)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init (init_weights below). The U2-NetP keeps
        its own (U2Net.init_weights)."""
        edge_net = set(self.u2net.modules()) if self.u2net is not None else set()
        init_weights(self, generator, skip=edge_net)

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
        # the stem convolves in its input's dtype (JAX's StemConv casts its
        # kernel to x.dtype: float32 after the U2-NetP's front-end), its
        # BatchNorm rounds to the policy's dtype
        x = self._policy(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(F.relu(x))
        for g in range(1, 5):
            if g > 1:
                # a denoising block hands on float32; JAX's next block casts
                # it in its first convolution and in its projection, which
                # every group after the first opens with
                x = self._policy(x)
            x = getattr(self, f"layer{g}")(x)
            if self.denoise:
                x = getattr(self, f"denoise{g}")(x)
        # the mean of a float32 x is float32, and the head casts it
        x = self._policy(_global_mean(x))
        return self.fc(x).float()

    def _policy(self, x):
        """x in the policy's compute dtype (as it is without one)."""
        return x if self.dtype is None else x.to(self.dtype)


_LAYOUTS = {18: (BasicBlock, (2, 2, 2, 2)), 34: (BasicBlock, (3, 4, 6, 3)),
            50: (Bottleneck, (3, 4, 6, 3)), 101: (Bottleneck, (3, 4, 23, 3)),
            152: (Bottleneck, (3, 8, 36, 3))}


def resnet(depth: int, num_classes: int = 200, ee: Optional[EEConfig] = None,
           square_source: Optional[Callable] = None,
           generator: Optional[torch.Generator] = None,
           dtype: Optional[torch.dtype] = None, denoise: bool = False) -> ResNet:
    if depth not in _LAYOUTS:
        raise NotImplementedError(
            f"resnet depth {depth}; ported: {sorted(_LAYOUTS)}")
    block, layers = _LAYOUTS[depth]
    return ResNet(block, layers, num_classes=num_classes, ee=ee,
                  square_source=square_source, generator=generator, dtype=dtype,
                  denoise=denoise)


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None,
                 skip=frozenset()) -> None:
    """The JAX package's init of its ResNets: conv N(0, 2/fan_out) with a
    zero bias where it has one, BN 1/0, Dense lecun-normal (truncated at 2
    std) with a zero bias; modules in `skip` keep theirs."""
    for m in (m for m in model.modules() if m not in skip):
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            # variance 1/fan_in after truncation at +-2 std
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()


class PreActBlock(nn.Module):
    """bn1-relu, then the projection shortcut (of the POST-activation
    tensor, where the shape changes), conv1 (the stride), bn2-relu, conv2;
    no activation after the sum."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm2d(inplanes)
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.shortcut = _preact_shortcut(inplanes, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = self.conv1(out)
        return self.conv2(F.relu(self.bn2(out))) + shortcut


class PreActBottleneck(nn.Module):
    """bn1-relu, the shortcut as in PreActBlock, 1x1 reduce, bn2-relu, 3x3
    (the stride), bn3-relu, 1x1 expand to 4 planes."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm2d(inplanes)
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn3 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.shortcut = _preact_shortcut(inplanes, planes * 4, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return self.conv3(F.relu(self.bn3(out))) + shortcut


def _preact_shortcut(inplanes: int, planes: int, stride: int):
    if stride == 1 and inplanes == planes:
        return None
    return nn.Sequential(_conv(inplanes, planes, 1, stride))


# the AWP drivers' dataset names -> class count
PREACT_CLASSES = {"CIFAR10": 10, "CIFAR100": 100, "ImageNet": 1000,
                  "Tiny-ImageNet": 200}
_PREACT_LAYOUTS = {18: (PreActBlock, (2, 2, 2, 2)), 34: (PreActBlock, (3, 4, 6, 3)),
                   50: (PreActBottleneck, (3, 4, 6, 3)),
                   101: (PreActBottleneck, (3, 4, 23, 3)),
                   152: (PreActBottleneck, (3, 8, 36, 3))}


class PreActResNet(nn.Module):
    """The AWP drivers' pre-activation ResNet: on CIFAR a 3x3 stem with no
    BatchNorm and no pool, elsewhere the 7x7 stride-2 stem, BatchNorm, relu
    and the 3x3 max pool; the four layer groups; a final BatchNorm and relu
    before the global mean; the head (`linear` on CIFAR, else `fc`). The
    class count follows `dataset`. The front-end and the dtype policy are
    the ResNet's."""

    def __init__(self, block=PreActBlock, layers=(2, 2, 2, 2),
                 dataset: str = "Tiny-ImageNet", ee: Optional[EEConfig] = None,
                 square_source: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if ee is not None:
            check_ported(ee)
        if dataset not in PREACT_CLASSES:
            raise NotImplementedError(f"PreActResNet dataset {dataset!r}")
        self.ee, self.square_source, self.dtype = ee, square_source, dtype
        self.dataset, self.cifar = dataset, dataset.startswith("CIFAR")
        if self.cifar:
            self.conv1 = _conv(3, 64, 3)
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for g, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if g == 0 else 2
            group = [block(inplanes, planes, stride)]
            inplanes = planes * block.expansion
            group += [block(inplanes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{g + 1}", nn.Sequential(*group))
        self.bn = BatchNorm2d(inplanes)
        setattr(self, "linear" if self.cifar else "fc",
                Linear(inplanes, PREACT_CLASSES[dataset]))
        init_weights(self, generator)

    @property
    def head(self) -> nn.Module:
        return self.linear if self.cifar else self.fc

    def forward(self, x, square_draws=None):
        """x: NHWC float32 in [0, 1] -> float32 logits (B, classes)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.ee is not None:
            source = (self.square_source if square_draws is None
                      else lambda shape, **_: square_draws)
            x = ee_frontend(x, self.ee, source)
        x = x.permute(0, 3, 1, 2)
        x = self.conv1(x)
        if not self.cifar:
            x = max_pool_3x3_s2(F.relu(self.bn1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = _global_mean(F.relu(self.bn(x)))
        return self.head(x).float()


def preact_resnet(depth: int, dataset: str = "Tiny-ImageNet",
                  ee: Optional[EEConfig] = None,
                  square_source: Optional[Callable] = None,
                  generator: Optional[torch.Generator] = None,
                  dtype: Optional[torch.dtype] = None) -> PreActResNet:
    if depth not in _PREACT_LAYOUTS:
        raise NotImplementedError(
            f"PreActResNet depth {depth}; ported: {sorted(_PREACT_LAYOUTS)}")
    block, layers = _PREACT_LAYOUTS[depth]
    return PreActResNet(block, layers, dataset=dataset, ee=ee,
                        square_source=square_source, generator=generator,
                        dtype=dtype)
