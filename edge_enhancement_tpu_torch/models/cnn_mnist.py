"""The MNIST CNN family, as edge_enhancement_tpu/models/cnn_mnist.py:

    Net2:           conv5x5(1->32) -> pool/relu -> conv5x5(32->64) +
                    Dropout2d -> pool/relu -> fc 1024 -> fc 10
    Net2_EE:        the same CNN behind the edge-enhancement front-end
    Net2_EE_square: the front-end with the square on its HFS branch

Both convolutions are VALID and carry biases. Dropout2d drops whole
(image, channel) maps with probability 0.5 and scales the kept ones by 2,
in train mode only. Its keep mask, (B, 64) booleans, comes from
`dropout_source(shape)` (as the square's draws come from `square_source`):
torch's generator cannot replay JAX's `dropout` stream, so tests hand the
model JAX's masks and the driver draws its own (`dropout_keep`).

Modules carry the reference's names (conv1, conv2, fc1, fc2). The flatten
before fc1 is torch's, (C, H, W); the JAX model flattens NHWC, so
convert.py permutes the rows of JAX's Dense_0 kernel. No BatchNorm: the
state_dict holds parameters only. Input is NHWC in [0, 1], as in the JAX
model; the convolutions run NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh
from .ee_frontend import EEConfig, check_ported, ee_frontend

DROP_RATE = 0.5
# conv2's channels and its pooled map at 28 x 28 input: fc1 takes 64 * 4 * 4
FEATURES, FEATURE_HW = 64, 4


def dropout_keep(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A Dropout2d keep mask for a (B, C, ...) map: (B, C) booleans, each
    True with probability 1 - DROP_RATE, drawn on the generator's device."""
    device = generator.device if generator is not None else None
    keep = mesh.draw_rows(lambda s: torch.rand(s, generator=generator, device=device),
                          tuple(shape[:2]))
    return keep >= DROP_RATE


class MnistCNN(nn.Module):
    """Net2, optionally behind the EE front-end (`ee`)."""

    def __init__(self, ee: Optional[EEConfig] = None, num_classes: int = 10,
                 square_source: Optional[Callable] = None,
                 dropout_source: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ee is not None:
            check_ported(ee)
        self.ee, self.square_source = ee, square_source
        self.dropout_source = dropout_source
        self.conv1 = nn.Conv2d(1, 32, 5)
        self.conv2 = nn.Conv2d(32, FEATURES, 5)
        self.fc1 = nn.Linear(FEATURES * FEATURE_HW * FEATURE_HW, 1024)
        self.fc2 = nn.Linear(1024, num_classes)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX model's init: conv kernels he-normal, Dense lecun-normal
        (both truncated at 2 std, variance 2/fan_in and 1/fan_in after
        truncation), zero biases."""
        for m, gain in ((self.conv1, 2.0), (self.conv2, 2.0),
                        (self.fc1, 1.0), (self.fc2, 1.0)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(gain / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()

    def forward(self, x, square_draws=None):
        """x: NHWC float32 in [0, 1] -> logits (B, num_classes).
        `square_draws` replaces the square source's draw."""
        if self.ee is not None:
            source = (self.square_source if square_draws is None
                      else lambda shape, **_: square_draws)
            x = ee_frontend(x, self.ee, source)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = self.conv2(x)
        if self.training:
            if self.dropout_source is None:
                raise ValueError("a train-mode Net2 forward needs a dropout source")
            keep = self.dropout_source(x.shape)
            keep = keep.to(torch.bool).reshape(x.shape[0], x.shape[1], 1, 1)
            x = torch.where(keep, x / (1.0 - DROP_RATE), torch.zeros_like(x))
        x = F.relu(F.max_pool2d(x, 2))
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)
