"""Training objectives, as edge_enhancement_tpu/objectives/methods.py, for
the ported kind `at`: PGD-AT against the TRAIN-mode model (BatchNorm moves
its running statistics on every attack forward), then cross-entropy on the
adversarial batch. The other kinds raise."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..attacks.pgd import PGDConfig, pgd_linf
from ..train.modelops import ModelOps, cross_entropy


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    method_name: str
    epsilon: float = 8.0 / 255
    num_steps: int = 10
    step_size: float = 2.0 / 255
    random: bool = True
    pre_square: bool = False


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


class Objective:
    """`loss(x, y)` -> (loss, metric logits) for one training method."""

    def __init__(self, ops: ModelOps, cfg: MethodConfig,
                 generator: Optional[torch.Generator] = None):
        self.ops, self.cfg, self.generator = ops, cfg, generator
        self.kind = canonical_method(cfg.method_name)
        if self.kind != "at" or cfg.pre_square:
            raise NotImplementedError(
                f"method {cfg.method_name!r} (kind {self.kind}"
                f"{', pre_square' if cfg.pre_square else ''}): only 'at' is ported")

    def loss(self, x: torch.Tensor, y: torch.Tensor):
        cfg = self.cfg
        pcfg = PGDConfig(cfg.epsilon, cfg.num_steps, cfg.step_size,
                         random_init="uniform" if cfg.random else "none")
        x_adv = pgd_linf(
            lambda xa: cross_entropy(self.ops.logits_train(xa), y, "sum"),
            x, pcfg, self.generator)
        logits = self.ops.logits_train(x_adv)
        return cross_entropy(logits, y, "mean"), logits
