"""The reference's step, plain PyTorch: a PGD adversarial-training step
with the recipe's plain SGD.

Every random draw is made on one generator seeded from the run's seed, in
the order in which the program draws on its own generator, so both sides
see the same draws: a forward of a square model draws its square first
(frontend.square_draws); PGD draws its uniform start before its first
forward.

Written from the recipe (Madry et al. 2018; the reference repository's
training loop); imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .resnet import ResNet


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuDNN's convolutions and for matmuls, as `on` says, inside."""
    was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def build(model_cfg: dict, weights: dict, seed: int, device) -> ResNet:
    """The reference model with `weights` (a state dict), and its draw
    generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = ResNet(model_cfg["depth"], model_cfg["num_classes"], model_cfg["ee"], gen)
    model.to(device).load_state_dict(weights)
    return model


def pixels(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 by true division."""
    return x_u8.float() / torch.full((), 255.0, device=x_u8.device)


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (2.0 * bound) - bound


def pgd_iterates(model: ResNet, x, y, eps: float, step: float, steps: int,
                 follow=None) -> dict:
    """L-inf PGD from a uniform start, on the model in its current mode,
    ascending the summed cross-entropy, recording the input of every
    forward (`inputs`, the last being x_adv, detached in [0, 1]). With `follow`
    (the program's forward inputs of the same attack), the first iteration
    starts from the reference's own start and every later one from the
    program's iterate, and the record holds the share of pixels where the
    program's iterate differs from the one the reference computes
    (`flip_share`, the worst iteration: a start drawn otherwise than the
    reference's shows in the first) and how far the program's start lies
    from the reference's (`start_gap`, the largest absolute difference).
    Without `follow` both are 0; a `follow` of another length than the
    attack's forwards reads as infinitely far and is not followed."""
    x = x.detach()
    xa = torch.clamp(x + _uniform(x.shape, eps, model.generator), 0.0, 1.0)
    lo, hi = x - eps, x + eps
    out = {"inputs": [xa], "start_gap": 0.0, "flip_share": 0.0}
    if follow is not None and len(follow) != steps + 1:
        out["start_gap"] = out["flip_share"] = math.inf
        follow = None
    if follow is not None:
        out["start_gap"] = (xa - follow[0]).abs().max().item()
    for k in range(steps):
        xa = xa.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(F.cross_entropy(model(xa), y, reduction="sum"), [xa])
        with torch.no_grad():
            xa = torch.clamp(torch.minimum(torch.maximum(xa + step * torch.sign(g), lo), hi),
                             0.0, 1.0)
        if follow is not None:
            share = (xa != follow[k + 1]).float().mean().item()
            out["flip_share"] = max(out["flip_share"], share)
            xa = follow[k + 1]
        out["inputs"].append(xa.detach())
    return out


def _loss(logits, y, half: bool):
    """The mean cross-entropy; the fault `half` takes it over the first
    half of the batch only."""
    if half:
        n = len(y) // 2
        return F.cross_entropy(logits[:n], y[:n])
    return F.cross_entropy(logits, y)


@torch.no_grad()
def sgd(params, grads, bufs, lr: float, momentum: float, wd: float) -> None:
    """buf = mu buf + g + wd p; p -= lr buf (torch.optim.SGD, dampening 0)."""
    for p, g, b in zip(params, grads, bufs):
        b.copy_(momentum * b + g + wd * p)
        p.sub_(lr * b)


def at_step(model: ResNet, bufs, x_u8, y, rec: dict, lr: float, follow=None,
            half: bool = False) -> dict:
    """One PGD-AT step: the attack on the train-mode model (following the
    program's iterates where `follow` gives them), the mean cross-entropy
    at x_adv, its parameter gradient and the SGD update. Returns the loss,
    the gradients, the forward inputs, `start_gap` and `flip_share`."""
    model.train()
    x = pixels(x_u8)
    out = pgd_iterates(model, x, y, rec["epsilon"], rec["step_size"], rec["num_steps"], follow)
    loss = _loss(model(out["inputs"][-1]), y, half)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    sgd(params, grads, bufs, lr, rec["momentum"], rec["weight_decay"])
    out.update(loss=loss.detach(), grads=grads)
    return out
