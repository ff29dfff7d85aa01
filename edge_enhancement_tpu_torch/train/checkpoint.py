"""Checkpoints of the train state, as edge_enhancement_tpu/train/checkpoint.py,
in the reference's torch.save format: a dict {epoch, arch, state_dict,
best_prec1, optimizer} in `<ckpt_dir>/checkpoint.pth.tar`, copied to
`model_best.pth.tar` when it is the best so far. The JAX package's
tools/convert_torch_checkpoint.py reads that format into Orbax, and its
`--to-torch` writes it back as one .pth file (without the optimizer), so a
checkpoint crosses between the two packages through that tool. Free-AT's
replay noise sits beside the checkpoint in `noise.pt`; under several
processes (parallel/mesh.py) each data rank writes its own rows to
`noise_p{rank}.pt`, as the JAX package's `noise_p{rank}.npy`, and only rank
0 writes the checkpoint (the replicas are equal). Under a `model` axis
(parallel/sharding.py) the weights and momentum are gathered over the
model group first, so the file is the one-process format, and a restore
cuts it to the rank's rows.

Every load is `torch.load(..., weights_only=True)`: the payloads hold
tensors, ints, floats, strings, bools, lists and dicts (the optimizer's
param_groups carry the lists and `nesterov`), all of which that loader
takes."""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ..parallel import mesh, sharding

FILES = {"last": "checkpoint.pth.tar", "best": "model_best.pth.tar"}
NOISE_FILE = "noise.pt"


def save_checkpoint(ckpt_dir: str, state, epoch: int, arch: str,
                    best_prec1: float, is_best: bool, opt, lr: float) -> str:
    """Write the state's checkpoint, the optimizer part in torch.optim.SGD's
    state_dict format, on rank 0 only (a cut state gathered over the model
    group first, by every rank); every rank returns its path once the file
    is whole."""
    path = os.path.join(ckpt_dir, FILES["last"])
    state_dict, momentum = sharding.gather_state(state)
    if mesh.rank() == 0:
        _write_checkpoint(path, state_dict, momentum, epoch, arch, best_prec1,
                          is_best, opt, lr)
    mesh.barrier()
    return path


def _write_checkpoint(path: str, state_dict: dict, momentum: list, epoch: int,
                      arch: str, best_prec1: float, is_best: bool, opt,
                      lr: float) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = len(momentum)
    payload = {
        "epoch": int(epoch), "arch": arch,
        "state_dict": state_dict,
        "best_prec1": float(best_prec1),      # a numpy scalar breaks weights_only
        "optimizer": {
            "state": {i: {"momentum_buffer": b} for i, b in enumerate(momentum)},
            "param_groups": [{"lr": lr, "momentum": opt.momentum,
                              "dampening": 0, "weight_decay": opt.weight_decay,
                              "nesterov": False, "params": list(range(n))}]},
    }
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, os.path.join(os.path.dirname(path), FILES["best"]))


def _strip_module(state_dict: dict) -> dict:
    """Drop DataParallel's `module.` prefix."""
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def load_checkpoint(path: str, which: str = "last") -> Optional[dict]:
    """The payload of a checkpoint directory's `which` ('last' or 'best')
    file, or of a .pth file (`which` then ignored); None when absent."""
    if os.path.isdir(path):
        path = os.path.join(path, FILES[which])
    if not os.path.isfile(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["state_dict"] = _strip_module(payload["state_dict"])
    return payload


def _check_shape(name: str, saved: torch.Tensor, live: torch.Tensor) -> None:
    if tuple(saved.shape) != tuple(live.shape):
        raise ValueError(f"checkpoint tensor {name} has shape "
                         f"{tuple(saved.shape)}, expected {tuple(live.shape)}")


def restore_into_state(state, payload: dict):
    """Copy a payload into `state` (its model and momentum buffers, on
    their devices); returns (state, epoch, best_prec1). Raises ValueError
    naming the tensor on a missing one or a shape mismatch. A payload
    without an optimizer part (the JAX converter's --to-torch export)
    leaves the momentum buffers at zero. Under a `model` axis the
    one-process payload is cut to this rank's rows first."""
    saved = sharding.cut_state_dict(payload["state_dict"])
    live = state.model.state_dict()
    for name, t in live.items():
        if name not in saved:
            raise ValueError(f"checkpoint has no tensor {name}")
        _check_shape(name, saved[name], t)
    bufs = []
    if payload.get("optimizer") is not None:
        saved_opt = payload["optimizer"]["state"]
        names = [n for n, _ in state.model.named_parameters()]
        for i, (name, buf) in enumerate(zip(names, state.momentum_buf)):
            key = f"optimizer.state[{i}].momentum_buffer ({name})"
            if "momentum_buffer" not in saved_opt.get(i, {}):
                raise ValueError(f"checkpoint has no {key}")
            b = sharding.cut_state_dict({name: saved_opt[i]["momentum_buffer"]})[name]
            _check_shape(key, b, buf)
            bufs.append(b)
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(saved[name])
        for buf, b in zip(state.momentum_buf, bufs):
            buf.copy_(b)
    return state, int(payload["epoch"]), float(payload["best_prec1"])


def noise_path(path: str, shard: Optional[int] = None) -> str:
    """`noise.pt`, or rank `shard`'s `noise_p{shard}.pt`, in a checkpoint
    directory or beside a checkpoint file."""
    name = NOISE_FILE if shard is None else f"noise_p{shard}.pt"
    return os.path.join(path if os.path.isdir(path) else os.path.dirname(path), name)


def _own_noise_path(path: str) -> str:
    """This process's noise file: noise.pt alone, noise_p{data rank}.pt
    under several data ranks."""
    return noise_path(path, mesh.data_rank() if mesh.data_size() > 1 else None)


def save_noise(ckpt_dir: str, noise: torch.Tensor) -> str:
    """Free-AT's replay noise (this process's rows) beside the checkpoint,
    written whole or not at all (a temporary file renamed over it), by
    model rank 0 of the data row (its model ranks hold the same rows);
    returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _own_noise_path(ckpt_dir)
    if mesh.model_rank() == 0:
        tmp = path + ".tmp"
        torch.save(noise.detach().cpu(), tmp)
        os.replace(tmp, path)
    return path


def load_noise(path: str) -> Optional[torch.Tensor]:
    """This process's replay noise saved with the checkpoint at `path` (a
    directory or a checkpoint file): its own file, else the file of a run
    with another process count (a single process's `noise.pt`, or rank 0's
    shard for a single process), whose shape the caller then finds wrong,
    as the JAX train.py finds a stale shard; None when neither exists."""
    other = noise_path(path) if mesh.data_size() > 1 else noise_path(path, 0)
    for p in (_own_noise_path(path), other):
        if os.path.isfile(p):
            return torch.load(p, map_location="cpu", weights_only=True)
    return None


def load_pretrained(model: torch.nn.Module, path: str):
    """Warm-start `model` from a torchvision-format state_dict (a raw .pth,
    or a payload with a `state_dict`, with or without `module.`), as the
    JAX package's load_pretrained_torch: tensors whose shapes differ from
    the model's (the classifier head of another class count) are skipped
    and keep their initial values. Returns (tensors loaded, skipped as
    (name, file shape, model shape))."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    saved = _strip_module(payload.get("state_dict", payload))
    live = model.state_dict()
    loaded, skipped = {}, []
    for name, t in saved.items():
        if name not in live:
            continue
        if tuple(t.shape) == tuple(live[name].shape):
            loaded[name] = t
        else:
            skipped.append((name, tuple(t.shape), tuple(live[name].shape)))
    model.load_state_dict(loaded, strict=False)
    return len(loaded), skipped
