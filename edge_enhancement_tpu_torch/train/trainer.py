"""Train state and the train/eval steps, as
edge_enhancement_tpu/train/trainer.py: one train step is the PGD attack,
the objective's loss, the parameter gradient and the SGD update; the eval
step is the reference validate(): clean and PGD accuracy in eval mode.
PyTorch runs eagerly, so a step is a plain function of the state."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..attacks.pgd import PGDConfig, pgd_linf
from ..objectives.methods import MethodConfig, Objective
from .modelops import ModelOps, cross_entropy, topk_accuracy
from .sgd import sgd_update


def to_float_pixels(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 by true division (the reciprocal form that
    CUDA uses for a Python-scalar divisor differs by one ulp for 126 of the
    256 values); float input passes through."""
    if x.dtype == torch.uint8:
        return x.float() / torch.tensor(255.0, device=x.device)
    return x


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    momentum_buf: list
    step: int = 0

    @property
    def params(self) -> list:
        return list(self.model.parameters())


def create_train_state(model: torch.nn.Module) -> TrainState:
    return TrainState(model, [torch.zeros_like(p) for p in model.parameters()])


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    momentum: float = 0.9
    weight_decay: float = 0.0
    bn_no_decay: bool = False   # fast-AT: no decay on BatchNorm's parameters


def build_train_step(ops: ModelOps, method: MethodConfig, opt: OptimConfig,
                     generator: Optional[torch.Generator] = None) -> Callable:
    """step(state, x, y, lr) -> metrics {loss, top1, top5} (0-dim tensors);
    updates state in place."""
    objective = Objective(ops, method, generator)

    def step_fn(state: TrainState, x, y, lr: float):
        x = to_float_pixels(x)
        loss, logits = objective.loss(x, y)
        params = state.params
        grads = torch.autograd.grad(loss, params)
        sgd_update(params, grads, state.momentum_buf, lr=lr,
                   momentum=opt.momentum, weight_decay=opt.weight_decay)
        state.step += 1
        return {"loss": loss.detach(), **topk_accuracy(logits.detach(), y)}

    return step_fn


@dataclasses.dataclass(frozen=True)
class EvalAttackConfig:
    """The validation attack: untargeted PGD (FGSM, CW, targeted attacks,
    restarts and pre_square of the JAX battery are not ported yet)."""
    epsilon: float = 8.0 / 255
    num_steps: int = 10
    step_size: float = 2.0 / 255
    random: bool = True


def build_eval_step(ops: ModelOps, atk: EvalAttackConfig,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """eval(state, x, y) -> metrics with clean_ / adv_ keys."""

    def eval_fn(state: TrainState, x, y):
        x = to_float_pixels(x)
        with torch.no_grad():
            clean = ops.logits_eval(x)
        metrics = {"clean_loss": cross_entropy(clean, y),
                   **{f"clean_{k}": v for k, v in topk_accuracy(clean, y).items()}}
        pcfg = PGDConfig(atk.epsilon, atk.num_steps, atk.step_size,
                         random_init="uniform" if atk.random else "none")
        x_adv = pgd_linf(lambda xa: cross_entropy(ops.logits_eval(xa), y, "sum"),
                         x, pcfg, generator)
        with torch.no_grad():
            adv = ops.logits_eval(x_adv)
        metrics.update({"adv_loss": cross_entropy(adv, y),
                        **{f"adv_{k}": v for k, v in topk_accuracy(adv, y).items()}})
        return metrics

    return eval_fn
