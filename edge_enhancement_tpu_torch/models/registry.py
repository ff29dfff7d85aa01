"""Arch string -> model, as edge_enhancement_tpu/models/registry.py, for the
ported architectures: resnet{18,34,50,101,152} with the suffixes _EE and
_EE_square (every `type_canny`: the three Canny variants and the learned
`u2netp`), in float32 or under the bf16 policy (the step125 Canny only);
and the U2-Net edge detectors `u2net` and `u2netp`."""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Optional

import torch

from .ee_frontend import EEConfig
from .resnet import resnet
from .u2net import u2net_full, u2net_small


def _ee_from_args(a: Mapping[str, Any], square: bool) -> EEConfig:
    return EEConfig(
        r=int(a.get("r", 16)), w=float(a.get("w", 0.5)),
        with_gf=bool(a.get("gf", False)),
        low=float(a.get("low", 60.0)), high=float(a.get("high", 120.0)),
        alpha=float(a.get("alpha", 0.0)), sigma=float(a.get("sigma", 1.0)),
        type_canny=str(a.get("type_canny", "CannyFilter")),
        square=square,
        epsilon=float(a.get("epsilon", 0.05)),
        n_queries=int(a.get("n_queries", 1)))


def dtype_from_args(a: Mapping[str, Any]) -> Optional[torch.dtype]:
    """The mixed-precision policy: `dtype: bf16|bfloat16` or the fast-AT
    key `half: true` select bfloat16 compute (parameters stay float32)."""
    if a.get("half") or str(a.get("dtype", "")).lower() in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None


def build_model(arch: str, args: Mapping[str, Any], num_classes: int, *,
                square_source: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None):
    """Construct (and initialise from `generator`) the model for `arch`."""
    a = dict(args)
    if arch == "u2net":
        return u2net_full(generator)
    if arch == "u2netp":
        return u2net_small(generator)
    m = re.fullmatch(r"resnet(\d+)(_EE_square|_EE)?", arch)
    if m is None:
        raise NotImplementedError(f"arch {arch!r} is not ported")
    suffix = m.group(2) or ""
    ee = _ee_from_args(a, square=suffix == "_EE_square") if suffix else None
    return resnet(int(m.group(1)), num_classes=num_classes, ee=ee,
                  square_source=square_source, generator=generator,
                  dtype=dtype_from_args(a))
