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

With no process group every function here is the identity, and every path
runs as a single process does. The JAX package's `model` axis
(parallel/sharding.py) has no counterpart yet.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def torchrun_env() -> bool:
    """True when torchrun (or torch.distributed.launch) started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device=None, *, backend: Optional[str] = None,
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None) -> torch.device:
    """Start this process's group and return its device.

    Without `init_method`: torchrun's environment (env://, RANK,
    WORLD_SIZE, MASTER_ADDR/MASTER_PORT), and a CUDA `device` without an
    index becomes cuda:LOCAL_RANK, which must exist. With `init_method`
    (a file:// or tcp:// address) and `rank`, `world_size`: the explicit
    form, the device as given; only this form puts two ranks on one card.
    The backend defaults to nccl on a CUDA device and gloo on the CPU."""
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
    return device


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


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
    return n * world_size()


def shard_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: rows r n / W to (r + 1) n / W,
    as the mesh's shard_batch lays a batch over the `data` axis."""
    w = world_size()
    if w == 1:
        return t
    n = t.shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} does not split over {w} processes")
    b = n // w
    return t[rank() * b:(rank() + 1) * b]


def draw_rows(draw: Callable, shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a local batch of shape[0] rows, made at the global
    batch's shape (every rank draws it from a generator seeded alike, so
    the generators stay in step) and cut to this rank's rows."""
    w = world_size()
    if w == 1:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * w,) + tuple(shape[1:]))
    return full[rank() * b:(rank() + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks; the gradient of each rank's input is the SUM of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The SUM of t over the ranks, differentiable."""
    if world_size() == 1:
        return t
    return _AllReduceSum.apply(t)


def sum_across(tensors: Sequence[torch.Tensor]) -> list:
    """The SUM over the ranks of each tensor (no autograd), one all-reduce
    of one flat buffer per (dtype, device)."""
    tensors = list(tensors)
    if world_size() == 1:
        return tensors
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def sum_step(grads: Sequence[torch.Tensor], metrics: dict):
    """A train step's one reduction: the parameter gradients and the
    metrics' partial sums, summed over the ranks together."""
    if world_size() == 1:
        return list(grads), metrics
    grads = list(grads)
    out = sum_across(grads + list(metrics.values()))
    return out[:len(grads)], dict(zip(metrics, out[len(grads):]))


def sum_metrics(metrics: dict) -> dict:
    """A dict of partial sums (0-dim tensors) summed over the ranks."""
    return sum_step([], metrics)[1]


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
