"""Data parallelism over processes, as edge_enhancement_tpu/parallel/mesh.py
shards a step over the mesh's `data` axis: one process a card (torchrun),
the parameters replicated, each process holding its rows of the global
batch.

    torchrun --nproc_per_node N -m edge_enhancement_tpu_torch.train --config ...

What the JAX package's sharding gives by construction, this module does by
hand, so that W processes compute what one process computes on the global
batch:

* BatchNorm in train mode reduces over the global batch
  (models/batchnorm.py, through `all_reduce_sum`, whose backward is a
  second all-reduce: an input gradient on one rank carries the other
  ranks' losses through the shared statistics).
* A loss or metric that JAX takes as a mean over the global batch is the
  local sum over the global batch size (`global_batch`), and the
  parameter gradients are summed once a step, one flat buffer per dtype
  (`sum_across`). Input gradients need no reduction.
* A random draw with one row per sample is drawn at the global batch's
  shape from a generator seeded alike on every rank, which keeps its rows
  (`draw_rows`): slicing one jax.random draw over the `data` axis.

The ranks form a (data, model) mesh, row-major as the JAX `make_mesh`
reshapes its devices: rank r has data index r // n_model and model index
r % n_model (`init(..., n_model=...)`; 1 by default). Everything above acts
on the `data` axis: the model ranks of one data row hold the same rows and
the same draws, and reduce over their data group (one model column). The
`model` axis (parallel/sharding.py) cuts the convolutions' and dense
layers' output channels over the model group of a data row
(`model_group`, `all_gather_model`, `all_reduce_model`).

With no process group every function here is the identity, and every path
runs as a single process does.

Every collective of a train step (`all_reduce_sum` and its backward,
`_sum_over` under `sum_step`, `sum_model`, the model axis's `_CopyToModel`
and `_gather`) can be captured in a CUDA graph under NCCL
(train/graphs.py): each is device work on the caller's current stream (a
clone, a cat or a zero fill, then `dist.all_reduce`, which ProcessGroupNCCL
joins to its own stream through events that the capture records), with no
host read and no host-to-device copy. A capture cannot create an NCCL
communicator: a group makes its own at its first collective, which the
chained step's eager first step runs before the capture. Gloo's
collectives on CUDA tensors pass through host memory and cannot be
captured.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


# the (data, model) layout of the ranks: n_model and this rank's two
# groups (None: the whole world), set by `init`
_LAYOUT: dict = {"n_model": 1, "data": None, "model": None}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"), None without a group."""
    return dist.get_backend() if initialized() else None


def model_size() -> int:
    """The `model` axis's length (1 without a model axis)."""
    return _LAYOUT["n_model"] if initialized() else 1


def model_rank() -> int:
    return rank() % model_size()


def data_size() -> int:
    """The `data` axis's length: the ranks over which a batch is split."""
    return world_size() // model_size()


def data_rank() -> int:
    return rank() // model_size()


def data_group():
    """This rank's data group (its model column; None: the whole world)."""
    return _LAYOUT["data"]


def model_group():
    """This rank's model group (its data row)."""
    return _LAYOUT["model"]


def _set_layout(n_model: int) -> None:
    """The (data, model) mesh of the world's ranks, row-major: one group a
    data row (the model groups) and one a model column (the data groups).
    Every rank creates every group, in the same order."""
    w = dist.get_world_size()
    if n_model < 1 or w % n_model:
        raise ValueError(f"{w} processes do not form a mesh with a model axis of {n_model}")
    _LAYOUT.update(n_model=n_model, data=None, model=None)
    if n_model == 1:
        return
    n_data, r = w // n_model, dist.get_rank()
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == r // n_model:
            _LAYOUT["model"] = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == r % n_model:
            _LAYOUT["data"] = g


def torchrun_env() -> bool:
    """True when torchrun (or torch.distributed.launch) started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device=None, *, backend: Optional[str] = None,
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None, n_model: int = 1) -> torch.device:
    """Start this process's group and return its device.

    Without `init_method`: torchrun's environment (env://, RANK,
    WORLD_SIZE, MASTER_ADDR/MASTER_PORT), and a CUDA `device` without an
    index becomes cuda:LOCAL_RANK, which must exist. With `init_method`
    (a file:// or tcp:// address) and `rank`, `world_size`: the explicit
    form, the device as given; only this form puts two ranks on one card.
    The backend defaults to nccl on a CUDA device and gloo on the CPU.
    `n_model` is the mesh's `model` axis (it must divide the world)."""
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA "
                    "device(s): one process a card (pass a device explicitly "
                    "to put two ranks on one card)")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)
    _set_layout(int(n_model))
    return device


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()
    _LAYOUT.update(n_model=1, data=None, model=None)


@contextlib.contextmanager
def torchrun_group(device):
    """The block's device: under torchrun with no group yet, a group for
    the block (destroyed on every way out) and this rank's card; else
    `device` as it is."""
    if not torchrun_env() or initialized():
        yield torch.device(device)
        return
    try:
        yield init(device)
    finally:
        shutdown()


def global_batch(n: int) -> int:
    """The global batch of a local batch of n rows (equal shards)."""
    return n * data_size()


def shard_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: rows d n / D to (d + 1) n / D of
    data index d of D, as the mesh's shard_batch lays a batch over the
    `data` axis."""
    w = data_size()
    if w == 1:
        return t
    n = t.shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} does not split over {w} processes")
    b = n // w
    return t[data_rank() * b:(data_rank() + 1) * b]


def draw_rows(draw: Callable, shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a local batch of shape[0] rows, made at the global
    batch's shape (every rank draws it from a generator seeded alike, so
    the generators stay in step) and cut to this rank's data rows."""
    w = data_size()
    if w == 1:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * w,) + tuple(shape[1:]))
    return full[data_rank() * b:(data_rank() + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    """SUM over a group's ranks; the gradient of each rank's input is the
    SUM of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The SUM of t over the data group, differentiable."""
    if data_size() == 1:
        return t
    return _AllReduceSum.apply(t, data_group())


class _CopyToModel(torch.autograd.Function):
    """The identity; the gradient is the SUM over the model group (each
    model rank's layer sees its own output channels' part of it)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=model_group())
        return out


def all_reduce_model(t: torch.Tensor) -> torch.Tensor:
    """t itself, its gradient summed over the model group: the input of a
    layer cut on its output channels."""
    if model_size() == 1:
        return t
    return _CopyToModel.apply(t)


class _SumModel(torch.autograd.Function):
    """SUM over the model group of a value that every model rank then uses
    alike; each rank's gradient is the output gradient (d sum / d part is
    1, and the output gradient is the same on every model rank)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, group=model_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return g


def sum_model(t: torch.Tensor) -> torch.Tensor:
    """The SUM of t over the model group, differentiable: the whole of a
    sum whose terms are cut over the model axis (a cut weight's norm or
    L1 norm is the sum of its model ranks' parts)."""
    if model_size() == 1:
        return t
    return _SumModel.apply(t)


def _gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's tensors concatenated along `dim`, in model rank
    order: an all-reduce of a zero-filled buffer into which each rank wrote
    its own slice, which is exact (x + 0 == x) and which gloo takes on CUDA
    tensors too (it may refuse a CUDA all-gather)."""
    n, k = model_size(), t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * k
    full = t.new_zeros(shape)
    full.narrow(dim, model_rank() * k, k).copy_(t)
    dist.all_reduce(full, group=model_group())
    return full


class _GatherModel(torch.autograd.Function):
    """The concatenation of the model ranks' slices along `dim`; each
    rank's gradient is its slice of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.k = dim, t.shape[dim]
        return _gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_rank() * ctx.k, ctx.k).contiguous(), None


def all_gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's slices of a tensor cut along `dim`, concatenated,
    differentiable."""
    if model_size() == 1:
        return t
    return _GatherModel.apply(t, dim)


def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`all_gather_model` without autograd (a state's tensors)."""
    if model_size() == 1:
        return t
    return _gather(t.detach(), dim)


def _sum_over(tensors: list, group) -> list:
    """The SUM over `group` of each tensor (no autograd), one all-reduce of
    one flat buffer per (dtype, device)."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def sum_across(tensors: Sequence[torch.Tensor]) -> list:
    """The SUM over the data group of each tensor (no autograd), one
    all-reduce of one flat buffer per (dtype, device)."""
    tensors = list(tensors)
    if data_size() == 1:
        return tensors
    return _sum_over(tensors, data_group())


def sum_step(grads: Sequence[torch.Tensor], metrics: dict,
             model: Optional[torch.nn.Module] = None):
    """A train step's reduction: the parameter gradients and the metrics'
    partial sums, summed over the data group together. Under a
    model axis `model` is the module whose parameters (in order) the
    gradients are: one cut over the model axis sums its own rows; one
    replicated over it is then averaged over the model group too. That
    leaves it as it is where the model ranks computed it alike
    ((g + g) / 2 == g), and keeps their replicas equal where a kernel that
    accumulates with atomics (bilinear upsampling's backward on a card) did
    not."""
    grads = list(grads)
    if data_size() > 1:
        out = sum_across(grads + list(metrics.values()))
        grads, metrics = out[:len(grads)], dict(zip(metrics, out[len(grads):]))
    if model_size() > 1:
        from .sharding import param_spec     # sharding imports this module
        named = list(model.named_parameters())
        if len(named) != len(grads):
            raise ValueError(f"{len(grads)} gradients for {len(named)} parameters")
        rep = [i for i, (n, p) in enumerate(named) if param_spec(n, p) is None]
        summed = _sum_over([grads[i] for i in rep], model_group())
        for i, g in zip(rep, summed):
            grads[i] = g / model_size()
    return grads, metrics


def sum_metrics(metrics: dict) -> dict:
    """A dict of partial sums (0-dim tensors) summed over the data group."""
    return dict(zip(metrics, sum_across(list(metrics.values()))))


@torch.no_grad()
def replicate(module_or_tensors) -> None:
    """Broadcast a module's parameters and buffers, or a list of tensors,
    from rank 0, in place."""
    if world_size() == 1:
        return
    tensors = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
               if isinstance(module_or_tensors, torch.nn.Module)
               else list(module_or_tensors))
    for t in tensors:
        dist.broadcast(t.data, src=0)
