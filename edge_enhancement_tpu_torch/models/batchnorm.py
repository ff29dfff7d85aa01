"""BatchNorm with flax's semantics, shared by the ResNets and U2-Net."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh


def _global_statistics(x: torch.Tensor):
    """(x - mean, mean, biased variance) per channel over the global batch
    of the data group's ranks (the model ranks of a data row hold the same
    rows: over the whole world they would count n_model times), in two passes: the all-reduced sum and count give the
    mean, the all-reduced sum of squared deviations the variance. Both
    all-reduces are differentiable."""
    n = x.numel() // x.shape[1]
    sums = mesh.all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                          x.new_full((1,), float(n))]))
    count = sums[-1].detach()
    mean = sums[:-1] / count
    d = x - mean[None, :, None, None]
    var = mesh.all_reduce_sum((d * d).sum(dim=(0, 2, 3))) / count
    return d, mean, var


class BatchNorm2d(nn.Module):
    """BatchNorm with flax's running-statistics rule: running_var moves
    toward the BIASED batch variance (torch's own BatchNorm uses the
    unbiased one). Momentum 0.9 in flax's sense (torch 0.1), eps 1e-5.

    A bfloat16 input computes as flax's BatchNorm with dtype=bf16: the
    statistics are reduced and the output normalised in float32, with the
    float32 parameters, and the output is rounded to bfloat16 once.

    Under several processes (parallel/mesh.py) train mode takes the
    statistics of the global batch, as the JAX package's BatchNorm does
    over the mesh's `data` axis (reduced over the data group only), and every rank moves its running
    statistics alike."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x):
        dtype = x.dtype
        x = x.to(torch.promote_types(dtype, torch.float32))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(dtype)
        if mesh.data_size() > 1:
            d, mean, var = _global_statistics(x)
            with torch.no_grad():
                self._update_running(mean, var)
            scale = torch.rsqrt(var + self.eps) * self.weight
            return (d * scale[None, :, None, None]
                    + self.bias[None, :, None, None]).to(dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(dtype)
