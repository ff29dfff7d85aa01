"""Training objectives, as edge_enhancement_tpu/objectives/methods.py: ST,
AT, targeted AT (and its trick), ALP and tarALP, TRADES, AVmixup and
tarAVmixup, each optionally after the training-time square (`pre_square`).

The JAX docstring's quirks hold here:
* AT-family and AVmixup attacks run against the TRAIN-mode model
  (BatchNorm moves its running statistics on every attack forward).
* ALP/TRADES attack the EVAL-mode model from a 0.001 N(0, 1) start, after a
  clean train-mode forward that moves the running statistics; ALP's
  adversarial logits (and TRADES' metric logits) are eval-mode, TRADES'
  loss recomputes train-mode adversarial logits.
* targeted AT trains on CE against the TRUE labels after a targeted attack.
* tarAVmixup's attack "targets" are fmod(one_hot + randint(1, n), n).

The JAX functions run the clean train-mode forward of ALP and TRADES twice
from the same statistics and key (a stop-gradient pass that moves the
statistics, then the gradient pass); this stateful port runs it once, with
the graph, and keeps that graph across the eval-mode attack, so the
running statistics move once and the square draws once on both sides, and
a model with dropout draws one mask for it, the mask that JAX's two passes
share (same key). The forwards after it in eval mode read the statistics
it wrote and save them for the backward; no later forward writes them
before the backward.

The objective's own draws (target offsets, tarAVmixup's offsets, AVmixup's
mixing weights, pre_square's square draws) are methods of `Objective`,
drawn from its generator; tests replace them to replay the JAX side's
draws. The attack's start draws are functions of attacks/pgd.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..attacks.pgd import PGDConfig, pgd_linf, random_targets
from ..ops.square import add_square, add_square_draws
from ..parallel import mesh
from ..train.modelops import (ModelOps, batch_mean, cross_entropy,
                              kl_div_batchmean, label_smooth_loss,
                              soft_cross_entropy_sum)


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    method_name: str
    epsilon: float = 8.0 / 255
    num_steps: int = 10
    step_size: float = 2.0 / 255
    random: bool = True
    beta: float = 1.0                 # ALP / TRADES weight
    num_classes: int = 10
    label_smooth: float = 0.0         # trick training
    prob_start_from_clean: float = 0.0
    gamma: float = 2.0                # AVmixup vertex scale
    lambda1: float = 1.0              # AVmixup clean label smoothing
    lambda2: float = 0.1              # AVmixup vertex label smoothing
    pre_square: bool = False          # square x before any kind
    square_epsilon: float = 0.05
    square_n_queries: int = 1


def canonical_method(name: str) -> str:
    """Map the reference's method_name strings onto objective kinds; the
    EE_*/FD_* prefixes select the architecture, not the loss."""
    if name == "ST":
        return "st"
    if "trick" in name:
        return "tar_at_trick"
    if "ALP" in name:
        return "tar_alp" if name.startswith("tar") else "alp"
    if "TRADES" in name.upper():
        return "trades"
    if "AVmixup" in name:
        return "tar_avmixup" if name.startswith("tar") else "avmixup"
    if name.startswith("tar"):
        return "tar_at"
    return "at"


def tar_init_policy(kind: str, random: bool) -> str:
    """The targeted family's start: none without `random`, the trick's
    gated start for tar_at_trick, else uniform."""
    if not random:
        return "none"
    return "trick" if kind == "tar_at_trick" else "uniform"


def _avmixup_label_smoothing(one_hot: torch.Tensor, factor: float,
                             nclass: int) -> torch.Tensor:
    """one_hot f + (one_hot - 1) (f - 1) / (nclass - 1)."""
    return one_hot * factor + (one_hot - 1.0) * ((factor - 1.0) / float(nclass - 1))


class Objective:
    """`loss(x, y)` -> (loss, metric logits) for one training method."""

    def __init__(self, ops: ModelOps, cfg: MethodConfig,
                 generator: Optional[torch.Generator] = None):
        self.ops, self.cfg, self.generator = ops, cfg, generator
        self.kind = canonical_method(cfg.method_name)

    # ---- the objective's draws ---------------------------------------------
    def target_offsets(self, y: torch.Tensor) -> torch.Tensor:
        """random_targets' offsets, U{1..n-1} per sample."""
        return mesh.draw_rows(lambda s: torch.randint(
            1, self.cfg.num_classes, s, generator=self.generator,
            device=y.device), y.shape)

    def avmixup_offsets(self, one_hot: torch.Tensor) -> torch.Tensor:
        """tarAVmixup's offsets, U{1..n-1} of one_hot's shape (B, n)."""
        return mesh.draw_rows(lambda s: torch.randint(
            1, self.cfg.num_classes, s, generator=self.generator,
            device=one_hot.device), one_hot.shape)

    def mix_weights(self, x: torch.Tensor) -> torch.Tensor:
        """AVmixup's w ~ U[0, 1) per sample (Beta(1, 1)), shaped to
        broadcast over x."""
        return mesh.draw_rows(lambda s: torch.rand(
            s, generator=self.generator, device=x.device, dtype=x.dtype),
            (x.shape[0],) + (1,) * (x.ndim - 1))

    def square_draws(self, shape):
        """pre_square's draws in the layout of ops/square.add_square_draws."""
        return add_square_draws(shape, self.generator,
                                n_queries=self.cfg.square_n_queries)

    def _pgd(self, init: str, ascend: bool) -> PGDConfig:
        cfg = self.cfg
        return PGDConfig(cfg.epsilon, cfg.num_steps, cfg.step_size,
                         random_init=init, ascend=ascend,
                         prob_start_from_clean=cfg.prob_start_from_clean)

    # ---- entry point ---------------------------------------------------------
    def loss(self, x: torch.Tensor, y: torch.Tensor):
        if self.cfg.pre_square:
            x = add_square(x, self.square_draws(x.shape),
                           epsilon=self.cfg.square_epsilon)
        kind = self.kind
        if kind == "st":
            logits = self.ops.logits_train(x)
            return cross_entropy(logits, y), logits
        if kind in ("at", "tar_at", "tar_at_trick"):
            return self._at_loss(x, y)
        if kind in ("alp", "tar_alp"):
            return self._alp_loss(x, y)
        if kind == "trades":
            return self._trades_loss(x, y)
        return self._avmixup_loss(x, y)         # avmixup, tar_avmixup

    def _targets(self, y):
        return random_targets(y, self.cfg.num_classes, offset=self.target_offsets(y))

    def _at_loss(self, x, y):
        cfg, ops = self.cfg, self.ops
        if self.kind == "at":
            labels, pcfg = y, self._pgd("uniform" if cfg.random else "none", True)
        else:
            labels = self._targets(y)
            pcfg = self._pgd(tar_init_policy(self.kind, cfg.random), False)
        x_adv = pgd_linf(lambda xa: cross_entropy(ops.logits_train(xa), labels, "sum"),
                         x, pcfg, self.generator)
        logits = ops.logits_train(x_adv)
        if self.kind == "tar_at_trick":
            return label_smooth_loss(logits, y, cfg.label_smooth), logits
        return cross_entropy(logits, y), logits

    def _alp_loss(self, x, y):
        ops = self.ops
        preds = ops.logits_train(x)
        labels = self._targets(y) if self.kind == "tar_alp" else y
        x_adv = pgd_linf(lambda xa: cross_entropy(ops.logits_eval(xa), labels),
                         x, self._pgd("gaussian", self.kind == "alp"),
                         self.generator)
        out = ops.logits_eval(x_adv)
        loss = (0.5 * cross_entropy(preds, y) + 0.5 * cross_entropy(out, y)
                + self.cfg.beta * batch_mean((preds - out) ** 2))
        return loss, out

    def _trades_loss(self, x, y):
        ops = self.ops
        preds = ops.logits_train(x)
        clean_prob0 = F.softmax(preds.detach(), dim=-1)
        x_adv = pgd_linf(
            lambda xa: kl_div_batchmean(F.log_softmax(ops.logits_eval(xa), dim=-1),
                                        clean_prob0),
            x, self._pgd("gaussian", True), self.generator)
        with torch.no_grad():
            metric_logits = ops.logits_eval(x_adv)
        adv_logits = ops.logits_train(x_adv)
        # the gradient flows through softmax(preds) too: not detached
        loss = cross_entropy(preds, y) + self.cfg.beta * kl_div_batchmean(
            F.log_softmax(adv_logits, dim=-1), F.softmax(preds, dim=-1))
        return loss, metric_logits

    def _avmixup_loss(self, x, y):
        cfg, ops = self.cfg, self.ops
        n = cfg.num_classes
        one_hot = F.one_hot(y.long(), n).to(x.dtype)
        if self.kind == "avmixup":
            targets, ascend = one_hot, True
        else:
            offs = self.avmixup_offsets(one_hot).to(x.dtype)
            targets = torch.remainder(one_hot + offs, float(n))
            ascend = False
        x_adv = pgd_linf(lambda xa: soft_cross_entropy_sum(ops.logits_train(xa), targets),
                         x, self._pgd("uniform" if cfg.random else "none", ascend),
                         self.generator)
        vertex = torch.clamp(x + cfg.gamma * (x_adv - x), 0.0, 1.0)
        y_nat = _avmixup_label_smoothing(one_hot, cfg.lambda1, n)
        y_vertex = _avmixup_label_smoothing(one_hot, cfg.lambda2, n)
        w = self.mix_weights(x)
        wy = w.reshape(-1, 1)
        x_mix = x * w + vertex * (1.0 - w)
        y_mix = y_nat * wy + y_vertex * (1.0 - wy)
        logits = ops.logits_train(x_mix)
        return (soft_cross_entropy_sum(logits, y_mix) / mesh.global_batch(x.shape[0]),
                logits)
