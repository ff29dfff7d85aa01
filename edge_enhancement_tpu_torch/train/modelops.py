"""Train- and eval-mode forwards and the losses, as
edge_enhancement_tpu/train/modelops.py.

Train mode normalises with batch statistics and moves the running
statistics on EVERY forward, including those inside a train-mode attack;
eval mode uses the running statistics. The square front-end draws fresh
randomness in both modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class ModelOps:
    def __init__(self, model: torch.nn.Module):
        self.model = model

    def logits_train(self, x: torch.Tensor) -> torch.Tensor:
        self.model.train()
        return self.model(x)

    def logits_eval(self, x: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.model(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """CE on integer labels."""
    return F.cross_entropy(logits, labels.long(), reduction=reduction)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> dict[str, torch.Tensor]:
    """top-k precision in percent."""
    pred = torch.topk(logits, max(ks), dim=-1).indices
    correct = pred == labels.long()[:, None]
    return {f"top{k}": 100.0 * correct[:, :k].any(dim=1).float().mean()
            for k in ks}
