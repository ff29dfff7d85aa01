"""Checkpoints of the train state, as edge_enhancement_tpu/train/checkpoint.py,
in the reference's torch.save format: a dict {epoch, arch, state_dict,
best_prec1, optimizer} in `<ckpt_dir>/checkpoint.pth.tar`, copied to
`model_best.pth.tar` when it is the best so far. The JAX package's
tools/convert_torch_checkpoint.py reads that format into Orbax, and its
`--to-torch` writes it back as one .pth file (without the optimizer), so a
checkpoint crosses between the two packages through that tool. Free-AT's
replay noise sits beside the checkpoint in `noise.pt`.

Every load is `torch.load(..., weights_only=True)`: the payloads hold
tensors, ints, floats, strings, bools, lists and dicts (the optimizer's
param_groups carry the lists and `nesterov`), all of which that loader
takes."""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

FILES = {"last": "checkpoint.pth.tar", "best": "model_best.pth.tar"}
NOISE_FILE = "noise.pt"


def save_checkpoint(ckpt_dir: str, state, epoch: int, arch: str,
                    best_prec1: float, is_best: bool, opt, lr: float) -> str:
    """Write the state's checkpoint, the optimizer part in torch.optim.SGD's
    state_dict format; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    n = len(state.momentum_buf)
    payload = {
        "epoch": int(epoch), "arch": arch,
        "state_dict": state.model.state_dict(),
        "best_prec1": float(best_prec1),      # a numpy scalar breaks weights_only
        "optimizer": {
            "state": {i: {"momentum_buffer": b}
                      for i, b in enumerate(state.momentum_buf)},
            "param_groups": [{"lr": lr, "momentum": opt.momentum,
                              "dampening": 0, "weight_decay": opt.weight_decay,
                              "nesterov": False, "params": list(range(n))}]},
    }
    path = os.path.join(ckpt_dir, FILES["last"])
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir, FILES["best"]))
    return path


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
    leaves the momentum buffers at zero."""
    saved = payload["state_dict"]
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
            _check_shape(key, saved_opt[i]["momentum_buffer"], buf)
            bufs.append(saved_opt[i]["momentum_buffer"])
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(saved[name])
        for buf, b in zip(state.momentum_buf, bufs):
            buf.copy_(b)
    return state, int(payload["epoch"]), float(payload["best_prec1"])


def noise_path(path: str) -> str:
    """`noise.pt` in a checkpoint directory, or beside a checkpoint file."""
    return os.path.join(path if os.path.isdir(path) else os.path.dirname(path),
                        NOISE_FILE)


def save_noise(ckpt_dir: str, noise: torch.Tensor) -> str:
    """Free-AT's replay noise beside the checkpoint; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = noise_path(ckpt_dir)
    torch.save(noise.detach().cpu(), path)
    return path


def load_noise(path: str) -> Optional[torch.Tensor]:
    """The replay noise saved with the checkpoint at `path` (a directory or
    a checkpoint file), None when absent."""
    p = noise_path(path)
    return torch.load(p, map_location="cpu", weights_only=True) if os.path.isfile(p) else None


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
