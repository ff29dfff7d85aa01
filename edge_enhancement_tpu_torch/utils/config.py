"""YAML + CLI config, as edge_enhancement_tpu/utils/config.py: the YAML is
loaded into an attribute-access dict, the dataset's defaults fill what it
leaves out, and the command line's values win."""

from __future__ import annotations

import argparse
from typing import Any, Mapping, Optional

import yaml


class Config(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


# dataset -> (default lr_schedule, num_classes, image size)
DATASET_DEFAULTS = {
    "mnist": {"lr_schedule": "multistep", "num_classes": 10, "cize": 28},
    "cifar100": {"lr_schedule": "piecewise_50_75", "num_classes": 100, "cize": 32},
    "tiny_imagenet": {"lr_schedule": "piecewise_50_75", "num_classes": 200, "cize": 64},
    "imagenet": {"lr_schedule": "step30", "num_classes": 1000, "cize": 224},
}


def load_config(path: str, cli_overrides: Optional[Mapping[str, Any]] = None) -> Config:
    with open(path) as f:
        cfg = Config(yaml.safe_load(f))
    dataset = cfg.get("dataset")
    if dataset in DATASET_DEFAULTS:
        for k, v in DATASET_DEFAULTS[dataset].items():
            cfg.setdefault(k, v)
    if cli_overrides:
        for k, v in cli_overrides.items():
            if v is not None:
                cfg[k] = v
    return cfg


def base_parser(description: str) -> argparse.ArgumentParser:
    """The JAX trainer's flags, which the port's drivers read."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--data", default=None,
                   help="dataset root dir, 'synthetic' or 'synthetic-hard'")
    p.add_argument("--evaluate", action="store_true", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir (or .pth file) to resume")
    p.add_argument("--pretrained", default=None,
                   help="warm-start the backbone from a torchvision-format "
                        "torch state_dict (.pth); shape-mismatched heads "
                        "keep their fresh init")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--steps-per-dispatch", dest="steps_per_dispatch",
                   type=int, default=None,
                   help="device-side multi-step loop: K train steps per "
                        "dispatch (a CUDA graph of the step replayed K times "
                        "on a card with one rank or under NCCL, its "
                        "all-reduces captured with it; a loop on the CPU and "
                        "on a card under gloo)")
    p.add_argument("--restarts", type=int, default=None,
                   help="PGD restarts for the validation battery")
    p.add_argument("--limit-batches", dest="limit_batches", type=int, default=None,
                   help="cap batches per epoch (smoke testing)")
    p.add_argument("--synthetic-size", dest="synthetic_size", type=int,
                   default=None,
                   help="train-split size when --data synthetic "
                        "(default 512; eval split uses half)")
    p.add_argument("--output", default="output", help="checkpoint/log root")
    p.add_argument("--print-freq", dest="print_freq", type=int, default=None)
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of train steps 1-3 of "
                        "the first epoch into this directory (rank 0)")
    p.add_argument("--platform", default=None,
                   help="cpu, or gpu / cuda: the device type (tpu raises)")
    return p
