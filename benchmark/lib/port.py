"""The system under test, built as its driver builds it: the model of the
configuration's arch, its ModelOps, a fresh train state and the run's
generator on the device, with the benchmark's weights (lib/weights.py)
loaded in place of the driver's CPU init. Everything the window drives
comes from edge_enhancement_tpu_torch."""

from __future__ import annotations

import functools

import torch

from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.ops.square import add_square_draws
from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.train.trainer import create_train_state

from .weights import draw_seed


def build(cfg: dict, weights: dict, seed: int, device):
    """(ops, state, generator): the model built on the meta device (no
    CPU init), moved to `device` empty and filled from `weights`; the
    generator of its square draws and its attacks seeded from `seed`."""
    gen = torch.Generator(device=device).manual_seed(draw_seed(seed))
    with torch.device("meta"):
        model = build_model(cfg["arch"], cfg, int(cfg["num_classes"]),
                            square_source=functools.partial(add_square_draws, generator=gen))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return ModelOps(model), create_train_state(model), gen


def pin_precision(cfg: dict) -> str:
    """The driver's precision rule: a float32 recipe with TF32 off."""
    return driver.pin_precision(cfg)
