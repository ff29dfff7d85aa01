"""SGD with momentum and coupled weight decay in torch.optim.SGD's semantics
(dampening 0, no Nesterov), as edge_enhancement_tpu/train/sgd.py:
buf = mu * buf + g + wd * p; p = p - lr * buf. The decay applies to every
parameter, BatchNorm's included, unless a decay mask says otherwise (fast-AT
excludes BatchNorm's weight and bias). Buffers start at zero, which equals
torch's first-step buf = g. Updates in place."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


@torch.no_grad()
def sgd_update(params, grads, momentum_buf, *, lr, momentum: float,
               weight_decay: float,
               decay_mask: Optional[Sequence[float]] = None) -> None:
    """`decay_mask`: one 0.0 or 1.0 for each parameter, scaling its decay.
    `lr` may be a 0-dim float32 tensor on the parameters' device, which a
    captured CUDA graph reads at each replay (train/graphs.py): the update
    takes the same bits as from the float."""
    masks = [1.0] * len(params) if decay_mask is None else decay_mask
    for p, g, b, m in zip(params, grads, momentum_buf, masks):
        b.copy_(momentum * b + g + weight_decay * m * p)
        p.sub_(lr * b)


def batchnorm_decay_mask(model: torch.nn.Module) -> list[float]:
    """1.0 for every parameter of `model` (in `parameters()` order) except
    those owned by a BatchNorm module, as the JAX mask tests its module
    path for "BatchNorm"."""
    owner = {id(p): type(m).__name__ for m in model.modules()
             for p in m.parameters(recurse=False)}
    return [0.0 if "BatchNorm" in owner[id(p)] else 1.0
            for p in model.parameters()]
