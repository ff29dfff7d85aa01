"""The weights of a run, made from its seed on the device: one draw of
normals for every convolution and the head, scaled a leaf (convolutions
N(0, 2 / fan_out), the head N(0, 1 / fan_in) clipped at 2 standard
deviations), BatchNorm's scale 1 and shift 0, biases 0, running
statistics 0 and 1. The names are torchvision's, which the program's
ResNet and the reference's both carry, so one state dict loads into
either."""

from __future__ import annotations

import math

import torch

from ..reference.resnet import ResNet


def make_weights(model_cfg: dict, seed: int, device) -> dict:
    """{name: tensor} of every parameter and buffer, float32 on `device`."""
    with torch.device("meta"):
        shapes = ResNet(model_cfg["depth"], model_cfg["num_classes"], model_cfg["ee"])
    gen = torch.Generator(device=device).manual_seed(seed)
    params = list(shapes.named_parameters())
    drawn = [(n, p) for n, p in params if p.dim() > 1]
    z = torch.randn(sum(p.numel() for _, p in drawn), generator=gen, device=device)
    out, at = {}, 0
    for name, p in drawn:
        w = z[at:at + p.numel()].view(p.shape)
        at += p.numel()
        if p.dim() == 4:
            out[name] = w * math.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
        else:
            out[name] = w.clamp(-2.0, 2.0) * math.sqrt(1.0 / p.shape[1])
    for name, p in params:
        if p.dim() == 1:
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(p.shape, fill, device=device)
    for name, b in shapes.named_buffers():
        out[name] = torch.full(b.shape, 1.0 if name.endswith("running_var") else 0.0,
                               device=device)
    return out


def draw_seed(seed: int) -> int:
    """The seed of the draws' generator (squares, attack starts), apart
    from the weights' stream."""
    return (2 * int(seed) + 1) % (1 << 63)
