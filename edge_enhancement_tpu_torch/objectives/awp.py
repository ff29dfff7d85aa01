"""Adversarial Weight Perturbation (AWP) training step, as
edge_enhancement_tpu/objectives/awp.py:

  1. x_adv = PGD (pgd_linf, uniform start) against the TRAIN-mode model,
     whose BatchNorm running statistics move on every attack forward.
  2. One plain-SGD ascent step at proxy_lr on CE(model(x_adv), y), from the
     post-attack statistics: proxy = w + proxy_lr * grad. The proxy
     forward's statistics update is thrown away.
  3. diff, on convolution and linear weights only (ndim > 1):
     (||w|| / (||proxy - w|| + 1e-20)) * (proxy - w), full-tensor norms;
     zero elsewhere.
  4. The robust loss CE(model_{w + gamma awp_on diff}(x_adv), y) (+ l1 times
     the perturbed weights' L1 norm), whose statistics update is kept; its
     gradient is taken with the weights perturbed in place, which are then
     restored to the exact saved w.
  5. The SGD step around the unperturbed w, with weight_decay * scale * diff
     folded into the gradient (torch's optimizer steps while the weights
     are perturbed, so its coupled decay sees w + scale * diff).

`awp_on` (0.0 or 1.0) is the driver's warmup gate. Under several
processes the proxy gradient and the robust gradient are each summed over
the ranks, so the perturbation is the global batch's, and the L1 term,
which every rank computes whole, enters each rank's loss over the world
size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..attacks.pgd import PGDConfig, pgd_linf
from ..parallel import mesh
from ..train.modelops import ModelOps, cross_entropy, topk_accuracy
from ..train.sgd import sgd_update
from ..train.trainer import OptimConfig, TrainState, to_float_pixels
from .methods import MethodConfig

_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class AWPConfig:
    gamma: float = 0.005
    warmup: int = 0          # epochs before AWP starts (awp_warmup)
    proxy_lr: float = 0.01   # the proxy's SGD step (awp_proxy_lr)
    l1: float = 0.0          # optional L1 term of the robust loss


def awp_diff(params, grads, proxy_lr: float) -> list:
    """The per-weight normalised perturbation from the proxy gradient;
    zeros for 1-D tensors (biases, BatchNorm)."""
    out = []
    for w, g in zip(params, grads):
        if w.ndim <= 1:
            out.append(torch.zeros_like(w))
            continue
        d = (w + proxy_lr * g) - w
        out.append((torch.linalg.vector_norm(w) /
                    (torch.linalg.vector_norm(d) + _EPS)) * d)
    return out


def build_awp_train_step(ops: ModelOps, method: MethodConfig, opt: OptimConfig,
                         awp: AWPConfig,
                         generator: Optional[torch.Generator] = None):
    """step(state, x, y, lr, awp_on) -> metrics {loss, top1, top5}; updates
    the state in place."""
    pcfg = PGDConfig(method.epsilon, method.num_steps, method.step_size,
                     random_init="uniform" if method.random else "none")

    if mesh.model_size() > 1:
        # awp_diff's per-weight norms and the L1 term would need sums over
        # the model group of a weight's rows
        raise NotImplementedError("AWP on a mesh with a model axis is not ported")

    def step_fn(state: TrainState, x, y, lr: float, awp_on: float):
        x = to_float_pixels(x)
        model, params = state.model, state.params
        x_adv = pgd_linf(lambda xa: cross_entropy(ops.logits_train(xa), y, "sum"),
                         x, pcfg, generator).detach()

        # the proxy's ascent step, its statistics update thrown away
        saved = [b.clone() for b in model.buffers()]
        g_proxy = mesh.sum_across(torch.autograd.grad(
            cross_entropy(ops.logits_train(x_adv), y), params))
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
            diff = awp_diff(params, g_proxy, awp.proxy_lr)
        scale = awp.gamma * float(awp_on)

        # the robust loss at the perturbed weights, then w restored exactly
        with torch.no_grad():
            w0 = [p.clone() for p in params]
            for p, d in zip(params, diff):
                p.copy_(p + scale * d)
        logits = ops.logits_train(x_adv)
        loss = cross_entropy(logits, y)
        if awp.l1 > 0:
            loss = loss + awp.l1 * sum(p.abs().sum() for p in params
                                       if p.ndim > 1) / mesh.data_size()
        grads, metrics = mesh.sum_step(
            torch.autograd.grad(loss, params),
            {"loss": loss.detach(), **topk_accuracy(logits.detach(), y)})
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
        if opt.weight_decay:
            grads = [g + opt.weight_decay * scale * d for g, d in zip(grads, diff)]
        sgd_update(params, grads, state.momentum_buf, lr=lr,
                   momentum=opt.momentum, weight_decay=opt.weight_decay)
        state.step += 1
        return metrics

    return step_fn
