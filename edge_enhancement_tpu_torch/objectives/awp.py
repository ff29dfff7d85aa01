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
the data group, so the perturbation is the global batch's, and the L1
term, which every data rank computes whole, enters each rank's loss over
the data axis's size. On a mesh with a model axis (parallel/sharding.py)
a rank holds its output rows of each convolution and dense weight: a cut
weight's norms in `awp_diff` (of w and of the proxy's step d) and its L1
term are the whole tensor's, sums of squares and of magnitudes summed over
the model group; replicated tensors keep their local norms. The robust
gradient of a replicated parameter is averaged over the model group by
`mesh.sum_step`, as in the flagship's step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..attacks.pgd import PGDConfig, pgd_linf
from ..parallel import mesh
from ..parallel.sharding import param_spec
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


def awp_diff(params, grads, proxy_lr: float, cut=None) -> list:
    """The per-weight normalised perturbation from the proxy gradient;
    zeros for 1-D tensors (biases, BatchNorm). `cut[i]`: params[i] is this
    rank's rows of a tensor cut over the model axis, whose norms are the
    whole tensor's (its model ranks' sums of squares summed)."""
    cut = cut or [False] * len(params)
    ds = [(w + proxy_lr * g) - w if w.ndim > 1 else None for w, g in zip(params, grads)]
    whole = [i for i, w in enumerate(params) if w.ndim > 1 and cut[i]]
    norms = {}
    if whole:
        squares = mesh.sum_model(torch.stack(
            [t.square().sum() for i in whole for t in (params[i], ds[i])]))
        norms = {i: squares[2 * j:2 * j + 2].sqrt() for j, i in enumerate(whole)}
    out = []
    for i, (w, d) in enumerate(zip(params, ds)):
        if d is None:
            out.append(torch.zeros_like(w))
            continue
        nw, nd = norms[i] if i in norms else (torch.linalg.vector_norm(w),
                                              torch.linalg.vector_norm(d))
        out.append((nw / (nd + _EPS)) * d)
    return out


def l1_norm(params, cut) -> torch.Tensor:
    """The L1 norm of the convolution and dense weights (ndim > 1), a cut
    weight's summed over the model group (differentiable: each rank's
    gradient is its own rows')."""
    rep = [p.abs().sum() for p, c in zip(params, cut) if p.ndim > 1 and not c]
    part = [p.abs().sum() for p, c in zip(params, cut) if p.ndim > 1 and c]
    total = sum(rep)
    if part:
        total = total + mesh.sum_model(sum(part))
    return total


def build_awp_train_step(ops: ModelOps, method: MethodConfig, opt: OptimConfig,
                         awp: AWPConfig,
                         generator: Optional[torch.Generator] = None):
    """step(state, x, y, lr, awp_on) -> metrics {loss, top1, top5}; updates
    the state in place."""
    pcfg = PGDConfig(method.epsilon, method.num_steps, method.step_size,
                     random_init="uniform" if method.random else "none")

    def step_fn(state: TrainState, x, y, lr: float, awp_on: float):
        x = to_float_pixels(x)
        model, params = state.model, state.params
        cut = [mesh.model_size() > 1 and param_spec(n, p) is not None
               for n, p in model.named_parameters()]
        x_adv = pgd_linf(lambda xa: cross_entropy(ops.logits_train(xa), y, "sum"),
                         x, pcfg, generator).detach()

        # the proxy's ascent step, its statistics update thrown away
        saved = [b.clone() for b in model.buffers()]
        g_proxy = mesh.sum_across(torch.autograd.grad(
            cross_entropy(ops.logits_train(x_adv), y), params))
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
            diff = awp_diff(params, g_proxy, awp.proxy_lr, cut)
        scale = awp.gamma * float(awp_on)

        # the robust loss at the perturbed weights, then w restored exactly
        with torch.no_grad():
            w0 = [p.clone() for p in params]
            for p, d in zip(params, diff):
                p.copy_(p + scale * d)
        logits = ops.logits_train(x_adv)
        loss = cross_entropy(logits, y)
        if awp.l1 > 0:
            loss = loss + awp.l1 * l1_norm(params, cut) / mesh.data_size()
        grads, metrics = mesh.sum_step(
            torch.autograd.grad(loss, params),
            {"loss": loss.detach(), **topk_accuracy(logits.detach(), y)}, model)
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
