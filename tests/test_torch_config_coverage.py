"""Which shipped configs the port runs: every
edge_enhancement_tpu/configs/**/*.yml through the port's refusals — the
driver's (`_check_ported`), the dataset's (`get_dataset`, synthetic data),
the model registry's with the front-end's (`build_model`, whose ResNet
calls `check_ported`), the objective's (`Objective`) and the validation
battery's (`build_eval_step`) — in the order the driver meets them. The
accepted list is the one ROADMAP.md counts."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import glob
import os

import torch

from edge_enhancement_tpu_torch.data.datasets import get_dataset
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.objectives.methods import Objective
from edge_enhancement_tpu_torch.train.driver import (_check_ported, eval_attack,
                                                     make_method_config)
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.train.trainer import build_eval_step
from edge_enhancement_tpu_torch.utils.config import load_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "edge_enhancement_tpu", "configs")
FAST = [f"fast_imagenet/fast_{px}_{phase}{ee}.yml" for px in ("2px", "4px")
        for phase in ("evaluate", "phase1", "phase2", "phase3") for ee in ("", "_ee")]
ACCEPTED = sorted(FAST + [
    "free_imagenet/free_at.yml", "free_imagenet/free_at_ee.yml",
    # `at` on ResNet-18
    "imagenet/adversarial_training.yml", "imagenet/at_ee_training.yml",
    "imagenet/ee_at_bpda3_square.yml", "tiny_imagenet/adversarial_training.yml",
    "tiny_imagenet/ee_at_bpda3_square.yml",
    # the other objectives of objectives/methods.py
    "imagenet/standard_training.yml", "imagenet/targeted_adversarial_training.yml",
    "imagenet/targeted_alp_training.yml", "imagenet/targeted_ee_at_bpda3_square.yml",
    "tiny_imagenet/standard_training.yml", "tiny_imagenet/alp_training.yml",
    "tiny_imagenet/avmixup_training.yml", "tiny_imagenet/ee_at_bpda3_pre_square.yml",
    "tiny_imagenet/targeted_adversarial_training.yml",
    "tiny_imagenet/targeted_alp_training.yml",
    "tiny_imagenet/targeted_avmixup_training.yml",
    "tiny_imagenet/targeted_ee_at_bpda3_square.yml", "tiny_imagenet/trades_training.yml",
    # the rest of the front-end: the full Canny (the ImageNet configs get it
    # as the registry's default) and the U2-NetP edge map
    "imagenet/targeted_ee_training.yml", "imagenet/targeted_ee_trick_training.yml",
    "tiny_imagenet/ee_at_square.yml", "tiny_imagenet/ee_at_training.yml",
    "tiny_imagenet/ee_at_u2netp.yml", "tiny_imagenet/processing_ee_at_square.yml",
    "tiny_imagenet/targeted_ee_training.yml",
    # the MNIST CNNs (Net2, Net2_EE, Net2_EE_square) on the MNIST loader
    *(f"mnist/{n}.yml" for n in (
        "adversarial_training", "alp_training", "avmixup", "ee_at_bpda3_square",
        "ee_at_training", "standard_training", "trades_training")),
    # the denoising ResNet
    "imagenet/targeted_feature_denoising_training.yml",
    "imagenet/targeted_feature_denoising_trick_training.yml",
    # AWP on the PreActResNets (the CIFAR-100 one on the CIFAR-100 loader)
    "awp_cifar100/at_awp.yml", "awp_tiny_imagenet/at_awp.yml",
    "awp_tiny_imagenet/ee_at_awp.yml", "awp_tiny_imagenet/ee_bpda_3_at_awp.yml",
    "awp_tiny_imagenet/ee_bpda_at_awp.yml",
])
# what refuses the others: none is refused
REFUSED = {}


def refusal(path: str):
    """None when the port runs the config, else the refusal's message."""
    cfg = load_config(path, dict(data="synthetic", device="cpu"))
    try:
        _check_ported(cfg)
        _, spec = get_dataset(cfg["dataset"], "synthetic", train=False,
                              synthetic_size=2, image_size=cfg.get("cize"))
        with torch.device("meta"):        # the checks, not the weights
            model = build_model(cfg["arch"], cfg, spec.num_classes)
        ops = ModelOps(model)
        Objective(ops, make_method_config(cfg, spec.num_classes))
        build_eval_step(ops, eval_attack(cfg, spec.num_classes))
    except NotImplementedError as e:
        return str(e)
    return None


def test_config_coverage():
    paths = sorted(glob.glob(os.path.join(CONFIGS, "**", "*.yml"), recursive=True))
    names = [os.path.relpath(p, CONFIGS) for p in paths]
    assert len(names) == 57
    found = {n: refusal(p) for n, p in zip(names, paths)}
    accepted = sorted(n for n, why in found.items() if why is None)
    assert accepted == ACCEPTED
    assert len(accepted) == 57 and len(REFUSED) == 0
    for n, why in found.items():
        if why is not None:
            assert REFUSED[n] in why, (n, why)
