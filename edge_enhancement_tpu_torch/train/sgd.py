"""SGD with momentum and coupled weight decay in torch.optim.SGD's semantics
(dampening 0, no Nesterov), as edge_enhancement_tpu/train/sgd.py:
buf = mu * buf + g + wd * p; p = p - lr * buf. The decay applies to every
parameter, BatchNorm's included. Buffers start at zero, which equals torch's
first-step buf = g. Updates in place."""

from __future__ import annotations

import torch


@torch.no_grad()
def sgd_update(params, grads, momentum_buf, *, lr: float, momentum: float,
               weight_decay: float) -> None:
    for p, g, b in zip(params, grads, momentum_buf):
        b.copy_(momentum * b + g + weight_decay * p)
        p.sub_(lr * b)
