"""Arch string -> model, as edge_enhancement_tpu/models/registry.py, for
every arch of the shipped configs: the MNIST CNNs Net2, Net2_EE and
Net2_EE_square; resnet{18,34,50,101,152} with the suffixes _EE, _EE_square
(every `type_canny`: the three Canny variants and the learned `u2netp`) and
_fd (the feature-denoising blocks); PreActResNet{18,...,152} with the
suffixes _EE, _EE_BPDA and _EE_BPDA_3; in float32 or under the bf16 policy
(the step125 Canny only); and the U2-Net edge detectors `u2net` and
`u2netp`."""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable, Mapping, Optional

import torch

from .cnn_mnist import MnistCNN, dropout_keep
from .ee_frontend import EEConfig
from .resnet import preact_resnet, resnet
from .u2net import u2net_full, u2net_small

# the PreAct EE variants' Canny comes from the arch's suffix, not the config
PREACT_CANNY = {"_EE": "CannyFilter", "_EE_BPDA": "CannyFilter_BPDA",
                "_EE_BPDA_3": "CannyFilter_step125_1"}
# config `dataset:` keys -> the AWP drivers' PreActResNet dataset names
PREACT_DATASETS = {"cifar100": "CIFAR100", "cifar10": "CIFAR10",
                   "tiny_imagenet": "Tiny-ImageNet", "imagenet": "ImageNet"}


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


def preact_dataset(a: Mapping[str, Any]) -> str:
    """The PreActResNet's dataset name: `dataset_variant`, else `dataset`,
    through PREACT_DATASETS (the stem and the class count follow it)."""
    raw = str(a.get("dataset_variant") or a.get("dataset", "Tiny-ImageNet"))
    return PREACT_DATASETS.get(raw, raw)


def build_model(arch: str, args: Mapping[str, Any], num_classes: int, *,
                square_source: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                dropout_source: Optional[Callable] = None):
    """Construct (and initialise from `generator`) the model for `arch`.
    `dropout_source` gives the MNIST CNNs' Dropout2d masks (default: drawn
    from `generator`). Net2 has 10 classes and the PreActResNets the class
    count of their dataset, whatever `num_classes` says, as in the JAX
    registry."""
    a = dict(args)
    if arch == "u2net":
        return u2net_full(generator)
    if arch == "u2netp":
        return u2net_small(generator)
    if arch in ("Net2", "Net2_EE", "Net2_EE_square"):
        if dropout_source is None:
            dropout_source = functools.partial(dropout_keep, generator=generator)
        ee = (None if arch == "Net2"
              else _ee_from_args(a, square=arch == "Net2_EE_square"))
        return MnistCNN(ee, square_source=square_source,
                        dropout_source=dropout_source, generator=generator)
    dtype = dtype_from_args(a)
    m = re.fullmatch(r"resnet(\d+)(_EE_square|_EE|_fd)?", arch)
    if m is not None:
        suffix = m.group(2) or ""
        ee = (_ee_from_args(a, square=suffix == "_EE_square")
              if suffix.startswith("_EE") else None)
        return resnet(int(m.group(1)), num_classes=num_classes, ee=ee,
                      square_source=square_source, generator=generator,
                      dtype=dtype, denoise=suffix == "_fd")
    m = re.fullmatch(r"PreActResNet(\d+)(_EE(?:_BPDA(?:_3)?)?)?", arch)
    if m is not None:
        suffix = m.group(2) or ""
        ee = None
        if suffix:
            ee = dataclasses.replace(_ee_from_args(a, square=False),
                                     type_canny=PREACT_CANNY[suffix])
        return preact_resnet(int(m.group(1)), dataset=preact_dataset(a), ee=ee,
                             square_source=square_source, generator=generator,
                             dtype=dtype)
    raise NotImplementedError(f"arch {arch!r} is not ported")
