"""Train- and eval-mode forwards and the losses (cross-entropy, the soft
and label-smoothed cross-entropies, batch-mean KL), as
edge_enhancement_tpu/train/modelops.py.

Train mode normalises with batch statistics and moves the running
statistics on EVERY forward, including those inside a train-mode attack,
and drops features where the model has dropout (the MNIST CNNs), a fresh
mask from the model's `dropout_source` each forward; eval mode uses the
running statistics and drops nothing. The square
front-end draws fresh randomness in both modes, unless an eval-mode
forward is handed draws (the attacks of attacks/autoattack.py share one
draw between forwards that JAX runs under one key).

Under several processes (parallel/mesh.py) a loss or metric that JAX
takes as a mean over the batch is this rank's sum over the GLOBAL batch of
the `data` axis (`batch_mean`): the ranks' values then sum to the global mean, and so do
their parameter gradients. With one process each is the mean it was.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.square import draw_squares
from ..parallel import mesh


class ModelOps:
    def __init__(self, model: torch.nn.Module):
        self.model = model

    def logits_train(self, x: torch.Tensor) -> torch.Tensor:
        self.model.train()
        return self.model(x)

    def logits_eval(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        """Eval-mode logits; `draws` (from `square_draws`) replaces the
        square front-end's fresh draw, so two forwards can share one."""
        self.model.eval()
        return self.model(x, square_draws=draws)

    def square_draws(self, x: torch.Tensor):
        """Fresh draws for one forward of x: the square front-end's, from
        the model's square source; None for a model without a square."""
        ee = getattr(self.model, "ee", None)
        if ee is None or not ee.square:
            return None
        return draw_squares(self.model.square_source, x.shape, int(ee.n_queries))


def batch_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean of v over the global batch (v's leading axis, shards of
    equal size): torch.mean in one process, this rank's share of it (the
    local sum over the global element count) under several."""
    if mesh.data_size() == 1:
        return torch.mean(v)
    return torch.sum(v) / mesh.global_batch(v.numel())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """CE on integer labels; 'mean' over the global batch (`batch_mean`)."""
    if reduction == "mean" and mesh.data_size() > 1:
        return batch_mean(F.cross_entropy(logits, labels.long(), reduction="none"))
    return F.cross_entropy(logits, labels.long(), reduction=reduction)


def soft_cross_entropy_sum(logits: torch.Tensor,
                           soft_targets: torch.Tensor) -> torch.Tensor:
    """-sum(log_softmax(logits) * targets), the AVmixup loss."""
    return -torch.sum(F.log_softmax(logits, dim=-1) * soft_targets)


def label_smooth_loss(logits: torch.Tensor, labels: torch.Tensor,
                      smoothing: float) -> torch.Tensor:
    """The trick's label smoothing: weight (1 - s) on the true class,
    s / (n - 1) elsewhere, mean over the batch."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    weight = torch.full_like(logp, smoothing / (n - 1.0))
    one_hot = F.one_hot(labels.long(), n).to(logits.dtype)
    weight = weight * (1.0 - one_hot) + one_hot * (1.0 - smoothing)
    return batch_mean(torch.sum(-weight * logp, dim=-1))


def kl_div_batchmean(log_q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """KL(p || q) summed and divided by the batch, from log q, with
    0 log 0 := 0 written out (value and gradient), as the JAX function."""
    logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)),
                       torch.zeros_like(p))
    return torch.sum(p * (logp - log_q)) / mesh.global_batch(log_q.shape[0])


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> dict[str, torch.Tensor]:
    """top-k precision in percent, over the global batch (`batch_mean`)."""
    pred = torch.topk(logits, max(ks), dim=-1).indices
    correct = pred == labels.long()[:, None]
    return {f"top{k}": 100.0 * batch_mean(correct[:, :k].any(dim=1).float())
            for k in ks}
