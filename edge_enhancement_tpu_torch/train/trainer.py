"""Train state and the train/eval steps, as
edge_enhancement_tpu/train/trainer.py: one train step is the objective's
loss (its attack included), the parameter gradient and the SGD update;
the eval step is the reference validate(): clean accuracy and one attack
battery (PGD, FGSM or CW) in eval mode.
PyTorch runs eagerly, so a step is a plain function of the state. Under
several processes (parallel/mesh.py) each rank runs the step on its rows;
the train step sums the parameter gradients and the metrics over the data
group in one all-reduce before the update, so every replica takes the
same update, and both steps return the global batch's metrics. A state
cut over the mesh's `model` axis (parallel/sharding.py's `shard_state`,
as JAX's step takes `state_sharding`) goes through the same steps: its
cut layers gather their outputs and sum their input gradients over the
model group themselves, so a cut parameter's gradient is this rank's rows
and a replicated one's is averaged over the model group (mesh.sum_step),
and the eval step runs the cut model."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ..attacks.cw import CWConfig, cw_linf
from ..attacks.pgd import PGDConfig, fgsm, pgd_linf, random_targets
from ..objectives.methods import MethodConfig, Objective
from ..ops.square import add_square, add_square_draws, draw_squares
from ..parallel import mesh
from .graphs import ChainedTrainStep
from .modelops import ModelOps, cross_entropy, topk_accuracy
from .sgd import sgd_update


_PIXEL_SCALE: dict = {}


def to_float_pixels(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 by true division (the reciprocal form that
    CUDA uses for a Python-scalar divisor differs by one ulp for 126 of the
    256 values); float input passes through. The divisor is a 0-dim tensor
    made once per device (a fill, not a host-to-device copy, which a CUDA
    graph's capture refuses)."""
    if x.dtype == torch.uint8:
        key = str(x.device)
        if key not in _PIXEL_SCALE:
            _PIXEL_SCALE[key] = torch.full((), 255.0, device=x.device)
        return x.float() / _PIXEL_SCALE[key]
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
    updates state in place. `lr` is a float or a 0-dim float32 tensor on
    the state's device (the same bits)."""
    objective = Objective(ops, method, generator)

    def step_fn(state: TrainState, x, y, lr: float):
        x = to_float_pixels(x)
        loss, logits = objective.loss(x, y)
        params = state.params
        grads, metrics = mesh.sum_step(
            torch.autograd.grad(loss, params),
            {"loss": loss.detach(), **topk_accuracy(logits.detach(), y)}, state.model)
        sgd_update(params, grads, state.momentum_buf, lr=lr,
                   momentum=opt.momentum, weight_decay=opt.weight_decay)
        state.step += 1
        return metrics

    return step_fn


def build_chained_train_step(ops: ModelOps, method: MethodConfig, opt: OptimConfig,
                             generator: Optional[torch.Generator] = None
                             ) -> ChainedTrainStep:
    """K train steps a dispatch, as the JAX package's
    build_chained_train_step: step(state, xs, ys, lr) on stacks of K
    batches, the state updated in place, state.step advanced by K, the
    last step's metrics returned. The math is K build_train_step calls in
    order, the draws taken from `generator` in step order (JAX draws a
    chain's keys apart from its single-step key stream); on CUDA tensors
    one train step is captured as a CUDA graph and replayed, on CPU
    tensors the step runs in a loop (train/graphs.py)."""
    return ChainedTrainStep(build_train_step(ops, method, opt, generator), generator)


@dataclasses.dataclass(frozen=True)
class EvalAttackConfig:
    """One battery of the reference validate(), eval mode throughout: PGD,
    FGSM, CW or none (clean only). `tar*` methods attack towards random
    wrong labels while accuracy is still taken against the true ones;
    `pre_square` methods square the inputs before the clean forward and the
    attack; PGD `restarts` keep the first run and swap in a restart that
    flips a prediction the earlier runs left correct. `unroll_cap` is the
    JAX package's loop unroll knob and does nothing here (no scan)."""
    attack_method: str = "PGD"     # PGD | FGSM | CW | none
    epsilon: float = 8.0 / 255
    num_steps: int = 10
    step_size: float = 2.0 / 255
    random: bool = True
    num_classes: int = 10
    cw_iters: int = 20
    restarts: int = 1
    targeted: bool = False
    pre_square: bool = False
    square_epsilon: float = 0.05
    square_n_queries: int = 1
    unroll_cap: Optional[int] = None


def eval_protocol(cfg) -> dict:
    """The validate() protocol of a config, shared by the driver's
    per-epoch and --evaluate validation and eval.py's batteries: tar* ->
    targeted attacks on random wrong labels, pre_square -> squared inputs,
    restarts, the unroll cap."""
    method = str(cfg.get("method_name", ""))
    return dict(
        targeted="tar" in method,
        pre_square="pre_square" in method,
        square_epsilon=float(cfg.get("epsilon", 0.05)),
        square_n_queries=int(cfg.get("n_queries", 1)),
        restarts=int(cfg.get("restarts", 1)),
        unroll_cap=(int(cfg["attack_unroll"])
                    if cfg.get("attack_unroll") is not None else None),
    )


def build_eval_step(ops: ModelOps, atk: EvalAttackConfig,
                    generator: Optional[torch.Generator] = None,
                    square_source: Optional[Callable] = None) -> Callable:
    """eval(state, x, y) -> metrics with clean_ / adv_ keys. The random
    draws come from `generator` (PGD and CW starts, targets) and
    `square_source(shape)` (pre_square's draws in the JAX layout; default
    ops/square.add_square_draws on `generator`)."""
    if atk.attack_method not in ("PGD", "FGSM", "CW", "none"):
        raise NotImplementedError(f"eval attack {atk.attack_method!r}")
    if atk.pre_square and square_source is None:
        square_source = functools.partial(add_square_draws, generator=generator)

    def eval_fn(state: TrainState, x, y):
        x = to_float_pixels(x)
        if atk.pre_square:
            x = add_square(x, draw_squares(square_source, x.shape, atk.square_n_queries),
                           epsilon=atk.square_epsilon)
        with torch.no_grad():
            clean = ops.logits_eval(x)
        metrics = {"clean_loss": cross_entropy(clean, y),
                   **{f"clean_{k}": v for k, v in topk_accuracy(clean, y).items()}}
        if atk.attack_method == "none":
            return mesh.sum_metrics(metrics)
        tgt = random_targets(y, atk.num_classes, generator) if atk.targeted else y

        def loss_fn(xa):
            return cross_entropy(ops.logits_eval(xa), tgt, "sum")

        if atk.attack_method == "PGD":
            pcfg = PGDConfig(atk.epsilon, atk.num_steps, atk.step_size,
                             random_init="uniform" if atk.random else "none",
                             ascend=not atk.targeted)
            x_adv = pgd_linf(loss_fn, x, pcfg, generator)
            for _ in range(1, atk.restarts):
                cand = pgd_linf(loss_fn, x, pcfg, generator)
                with torch.no_grad():
                    broke = ops.logits_eval(cand).argmax(dim=-1) != y
                    x_adv = torch.where(broke.view((-1,) + (1,) * (x.ndim - 1)),
                                        cand, x_adv)
        elif atk.attack_method == "FGSM":
            x_adv = fgsm(loss_fn, x, step_size=atk.step_size,
                         targeted=atk.targeted)
        else:
            ccfg = CWConfig(magnitude=atk.epsilon, max_eps=atk.epsilon,
                            max_iters=atk.cw_iters, num_classes=atk.num_classes)
            x_adv, _ = cw_linf(ops.logits_eval, x, y, ccfg, generator,
                               target=tgt if atk.targeted else None)
        with torch.no_grad():
            adv = ops.logits_eval(x_adv)
        metrics.update({"adv_loss": cross_entropy(adv, y),
                        **{f"adv_{k}": v for k, v in topk_accuracy(adv, y).items()}})
        return mesh.sum_metrics(metrics)

    return eval_fn
