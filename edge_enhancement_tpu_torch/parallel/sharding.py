"""The mesh's `model` axis, as edge_enhancement_tpu/parallel/sharding.py:
output-channel (column) parallel convolutions and dense layers over the
model group of a data row (parallel/mesh.py, `init(..., n_model=...)`).

The JAX rule on the port's layouts:

  Conv2d weight (out, in, kh, kw)    cut on dim 0 (JAX: (h, w, in, out) on `model`)
  Linear weight (out, in)            cut on dim 0 (JAX: (in, out) on `model`)
  biases, BatchNorm parameters and   replicated
  running statistics
  momentum                           as its parameter

GSPMD inserts the collectives in JAX; here each cut layer does it by hand.
Its input passes `mesh.all_reduce_model`, the identity whose backward sums
the input gradient over the model group (each rank's layer back-propagates
its own output channels only). It computes its own output channels,
`mesh.all_gather_model` concatenates them (the backward: this rank's
slice), and the replicated bias is added after the gather. Everything
between two cut layers (the front-end, BatchNorm, pooling) is replicated
over the model group, as GSPMD replicates it. A parameter's gradient is
summed over the data group (mesh.sum_step): a cut one holds this rank's
rows; a replicated one is also averaged over the model group, which keeps
the model ranks' replicas equal.

    mesh.init(device, ..., n_model=2)
    model = build_model(...)         # the full model, the same on every rank
    state = shard_state(create_train_state(model))
    step = build_train_step(ModelOps(state.model), ...)

Checkpoints stay in the one-process format: train/checkpoint.py gathers a
state over the model group before rank 0 writes (`gather_state`) and cuts a
restored one to the rank's rows (`cut_state_dict`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mesh


def param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dim of a parameter (or momentum buffer, or state_dict entry)
    that the `model` axis cuts, None where it is replicated: the weight of
    a convolution (4-D) or of a dense layer (2-D), on its output dim."""
    if name.rsplit(".", 1)[-1] == "weight" and tensor.ndim in (2, 4):
        return 0
    return None


class ColumnParallelConv2d(nn.Conv2d):
    """A convolution holding its model rank's output channels of the
    weight and the whole bias, in its input's dtype (the weight cast at
    use, as models/resnet.py's Conv2d)."""

    def forward(self, x):
        x = mesh.all_reduce_model(x)
        y = mesh.all_gather_model(self._conv_forward(x, self.weight.to(x.dtype), None), 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class ColumnParallelLinear(nn.Linear):
    """A dense layer holding its model rank's output rows of the weight and
    the whole bias: x W^T in x's dtype, gathered, then + b."""

    def forward(self, x):
        x = mesh.all_reduce_model(x)
        y = mesh.all_gather_model(F.linear(x, self.weight.to(x.dtype)), x.ndim - 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _cut(t: torch.Tensor) -> torch.Tensor:
    """This model rank's rows of t."""
    k = t.shape[0] // mesh.model_size()
    return t[mesh.model_rank() * k:(mesh.model_rank() + 1) * k]


def shard_model(model: nn.Module) -> nn.Module:
    """Cut every convolution and dense layer of `model` (in place) to this
    process's model rank: its weight keeps that rank's output rows, and the
    layer becomes its column-parallel counterpart. Raises ValueError,
    naming the layer, where an output width does not divide by the model
    axis (before anything is cut), as a JAX NamedSharding refuses it."""
    size = mesh.model_size()
    if size == 1:
        return model
    modules = dict(model.named_modules())
    layers = []
    for name, p in model.named_parameters():
        if param_spec(name, p) is None:
            continue
        owner = name.rsplit(".", 1)[0]
        layer = modules[owner]
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            raise TypeError(f"{owner}: a {type(layer).__name__} weight has no "
                            "column-parallel form")
        if p.shape[0] % size:
            raise ValueError(f"{owner}: {p.shape[0]} output channels do not divide "
                             f"over a model axis of {size}")
        layers.append(layer)
    for layer in layers:
        layer.weight = nn.Parameter(_cut(layer.weight.detach()).clone(),
                                    requires_grad=layer.weight.requires_grad)
        if isinstance(layer, nn.Conv2d):
            layer.__class__ = ColumnParallelConv2d
            layer.out_channels = layer.weight.shape[0]
        else:
            layer.__class__ = ColumnParallelLinear
            layer.out_features = layer.weight.shape[0]
    return model


def cut_state_dict(state_dict: dict) -> dict:
    """A one-process state_dict (or {name: momentum buffer}) cut to this
    process's model rank's rows."""
    if mesh.model_size() == 1:
        return dict(state_dict)
    return {k: _cut(v) if param_spec(k, v) is not None else v
            for k, v in state_dict.items()}


def shard_state(state):
    """A train state (train/trainer.py) of the full model cut to this
    process's model rank's rows: the model (`shard_model`) and its momentum
    buffers."""
    names = [n for n, _ in state.model.named_parameters()]
    shard_model(state.model)
    cut = cut_state_dict(dict(zip(names, state.momentum_buf)))
    state.momentum_buf = [cut[n].clone() for n in names]
    return state


def gather_state(state) -> tuple[dict, list]:
    """(state_dict, momentum buffers) of a cut train state in the one-process
    format, gathered over the model group: a collective, every rank of the
    group calls it. Without a model axis, the state's own."""
    sd = state.model.state_dict()
    if mesh.model_size() == 1:
        return sd, list(state.momentum_buf)
    names = [n for n, _ in state.model.named_parameters()]

    def full(name, t):
        return mesh.gather_model(t, 0) if param_spec(name, t) is not None else t
    return ({k: full(k, v) for k, v in sd.items()},
            [full(n, b) for n, b in zip(names, state.momentum_buf)])
