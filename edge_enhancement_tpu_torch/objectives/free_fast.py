"""Free adversarial training (replay) and fast (FGSM) adversarial training,
as edge_enhancement_tpu/objectives/free_fast.py.

* Free-AT: a noise buffer that persists across batches; each batch runs
  n_repeats of {one train-mode forward on clip(x + noise), one backward
  that gives both the parameter gradients and the noise gradient,
  noise <- clip(noise + fgsm_step sign(g), +-clip_eps), the SGD update}.
  The driver divides the epochs by n_repeats.
* Fast-AT: each repeat (re)draws the noise uniformly when random_init,
  ascends on the noise alone (BatchNorm statistics still move), then
  descends on the model with the noise fixed. The descent asks for no
  input gradient, so the front-end's backward kernel does not run for it.

Both run the train-mode model on every pass, as the JAX package and the
reference do. Under several processes each rank keeps the noise of its own
rows (the JAX package's noise is sharded with the batch), and the
parameter gradient of every replay is summed over the ranks before its
update. A step updates the state in place and returns (noise,
metrics); the fast step takes the uniform draws as an argument, so that a
test can hand it JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..ops.square import clip01
from ..parallel import mesh
from ..train.modelops import ModelOps, cross_entropy, topk_accuracy
from ..train.sgd import batchnorm_decay_mask, sgd_update
from ..train.trainer import OptimConfig, TrainState, to_float_pixels


@dataclasses.dataclass(frozen=True)
class FreeFastConfig:
    n_repeats: int = 4
    fgsm_step: float = 4.0 / 255
    clip_eps: float = 4.0 / 255
    random_init: bool = True     # fast-AT: redraw the noise every repeat


def init_noise(batch_size: int, image_size: int, channels: int = 3,
               device=None) -> torch.Tensor:
    """The free-AT replay buffer, NHWC float32 zeros."""
    return torch.zeros((batch_size, image_size, image_size, channels),
                       device=device)


def _step_noise(noise, g, cfg: FreeFastConfig) -> torch.Tensor:
    return torch.clamp(noise + cfg.fgsm_step * torch.sign(g),
                       -cfg.clip_eps, cfg.clip_eps)


def _sgd(state: TrainState, grads, lr: float, opt: OptimConfig, mask):
    sgd_update(state.params, grads, state.momentum_buf, lr=lr,
               momentum=opt.momentum, weight_decay=opt.weight_decay,
               decay_mask=mask)


def build_free_train_step(ops: ModelOps, cfg: FreeFastConfig,
                          opt: OptimConfig) -> Callable:
    """step(state, noise, x, y, lr) -> (noise, metrics {loss, top1, top5})."""

    def step_fn(state: TrainState, noise, x, y, lr: float):
        x = to_float_pixels(x)
        mask = batchnorm_decay_mask(state.model) if opt.bn_no_decay else None
        for r in range(cfg.n_repeats):
            nz = noise.detach().requires_grad_(True)
            logits = ops.logits_train(clip01(x + nz))
            loss = cross_entropy(logits, y, "mean")
            *grads, g_noise = torch.autograd.grad(loss, [*state.params, nz])
            with torch.no_grad():
                noise = _step_noise(noise, g_noise, cfg)
            metrics = ({"loss": loss.detach(), **topk_accuracy(logits.detach(), y)}
                       if r == cfg.n_repeats - 1 else {})
            grads, metrics = mesh.sum_step(grads, metrics, state.model)
            _sgd(state, grads, lr, opt, mask)
        state.step += cfg.n_repeats
        return noise, metrics

    return step_fn


def uniform_draws(cfg: FreeFastConfig, shape, generator: torch.Generator,
                  device=None) -> list:
    """Fast-AT's noise for each repeat: U[-clip_eps, clip_eps)."""
    return [mesh.draw_rows(lambda s: torch.rand(s, generator=generator, device=device),
                           shape) * (2.0 * cfg.clip_eps) - cfg.clip_eps
            for _ in range(cfg.n_repeats)]


def build_fast_train_step(ops: ModelOps, cfg: FreeFastConfig,
                          opt: OptimConfig,
                          generator: Optional[torch.Generator] = None) -> Callable:
    """step(state, noise, x, y, lr, draws=None) -> (noise, metrics). `draws`
    (one per repeat) replaces the uniform draws from `generator`."""

    def step_fn(state: TrainState, noise, x, y, lr: float,
                draws: Optional[Sequence[torch.Tensor]] = None):
        x = to_float_pixels(x)
        mask = batchnorm_decay_mask(state.model) if opt.bn_no_decay else None
        if cfg.random_init and draws is None:
            draws = uniform_draws(cfg, noise.shape, generator, noise.device)
        for r in range(cfg.n_repeats):
            if cfg.random_init:
                noise = draws[r]
            nz = noise.detach().requires_grad_(True)
            loss = cross_entropy(ops.logits_train(clip01(x + nz)), y, "mean")
            (g_noise,) = torch.autograd.grad(loss, [nz])
            with torch.no_grad():
                noise = _step_noise(noise, g_noise, cfg)
            logits = ops.logits_train(clip01(x + noise))
            loss = cross_entropy(logits, y, "mean")
            metrics = ({"loss": loss.detach(), **topk_accuracy(logits.detach(), y)}
                       if r == cfg.n_repeats - 1 else {})
            grads, metrics = mesh.sum_step(torch.autograd.grad(loss, state.params),
                                           metrics, state.model)
            _sgd(state, grads, lr, opt, mask)
        state.step += cfg.n_repeats
        return noise, metrics

    return step_fn
