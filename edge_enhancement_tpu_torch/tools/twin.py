"""Whole-training twin of the port: the committed twin recipes of the JAX
package (`output/twin_hard*/twin_hard.json`) trained end to end by the
port, seed by seed, and held at convergence against the committed runs.

    python -m edge_enhancement_tpu_torch.tools.twin --family flagship \\
        --seeds 1 2 3 [--device cpu] [--out output/twin_port]

Families and the committed run each reads its recipe from (never retyped):
flagship -> twin_hard (resnet18_EE_square, EE_BPDA3_AT_square), tar ->
twin_hard_tar (targeted), trades -> twin_hard_trades, alp ->
twin_hard_alp (resnet18), awp -> twin_hard_awp (PreActResNet18_EE_BPDA_3,
EE_AT_AWP). A run is float32 with TF32 off (`driver.pin_precision`) in
single eager steps on CUDA, or on the CPU with --device cpu (no fallback).

Each seed: `synthetic_hard_images(n_train, seed=0)` trains and `(n_val,
seed=1)` validates; the train batches are `ArrayDataset.batches(25,
shuffle=True, seed=seed, epoch=epoch)`, the JAX package's stream, so a
seed's batch order is the committed run's. The committed runs started from
the PyTorch reference's initialisation, converted, which is not in the
repo: the comparison is unpaired and made at convergence, not step by
step. A seed starts from weights drawn on the CPU from a generator seeded
with the seed and moved to the device, so the same on the card and on the
CPU, from the distribution of the committed runs' reference model
(FAMILIES): for the ResNet-18 families the port's own initialisation
(`models/resnet.py::init_weights`, the JAX package's, whose convolutions
follow the reference ResNet's init loop); for AWP torch's default
initialisation (`torch_default_init`), which the reference PreActResNet
keeps, where the port's and the JAX package's PreActResNet draw their
convolutions from the ResNet's N(0, 2/fan_out), 2.46x the default's
spread, and on this recipe converge lower (--init port;
output/twin_port/port_init/).

Every epoch validates with PGD (the recipe's `num_steps_1` steps, or
AWP's 20, random start; targeted for tar* methods) on draws seeded seed +
777 anew each epoch, as the committed runs' eval key; the train steps draw
from a generator seeded with the seed. The generic families take a constant learning rate; AWP
takes `piecewise_50_75` at epoch + (i + 1) / n_batches every minibatch
with the gate on from `awp_warmup`.

The statistic (`statistic`, written to <out>/summary.json): converged = the
mean of the last 2 epochs; for clean and adversarial top-1, gap =
|mean(port) - mean(JAX)| over the seeds, band = the largest seed range of
the reference's, the JAX package's and the port's runs (each an
independent draw of the recipe's noise); a family passes when gap <= band
+ 1.0 and the port's means are mid-band (MID_BAND). The gap to the
reference's mean is reported beside it.

--epochs, --n-train, --n-val and --num-steps (the train and validation
attack's steps) shrink a run for tests; --init port|torch overrides the
family's initialisation.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from ..data.datasets import ArrayDataset, synthetic_hard_images
from ..objectives.awp import build_awp_train_step
from ..ops.cuda import ee_fused, gemm_conv
from ..train import schedules
from ..train.driver import (awp_config, build, eval_attack, make_method_config,
                            pin_precision, run_device)
from ..train.trainer import OptimConfig, build_eval_step, build_train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# family -> (committed twin directory under output/, the committed gate's
# upper bound on the converged clean mean: tests/test_digital_twin_tiny.py,
# the initialisation of the committed runs' reference model)
FAMILIES = {"flagship": ("twin_hard", 95.0, "port"), "tar": ("twin_hard_tar", 95.0, "port"),
            "trades": ("twin_hard_trades", 97.0, "port"),
            "alp": ("twin_hard_alp", 95.0, "port"), "awp": ("twin_hard_awp", 95.0, "torch")}
NUM_CLASSES = 200          # the Tiny-ImageNet heads of the committed runs
AWP_EVAL_STEPS = 20        # ee_bpda_3_at_awp.yml's num_steps_2
EVAL_SEED_OFFSET = 777
N_VAL = 250
CONVERGED_EPOCHS = 2
MARGIN = 1.0               # the committed gate's margin on gap <= band
# the committed gate's mid-band checks: LO <= clean <= clean_hi,
# adv <= clean - ATTACKABLE, adv >= LEARNABLE
MID_BAND = dict(lo=40.0, attackable=5.0, learnable=30.0)


def committed(family: str) -> dict:
    """The committed twin run of a family (recipe, seeds, and per-seed
    histories of the reference and of the JAX package, "ours")."""
    path = os.path.join(REPO, "output", FAMILIES[family][0], "twin_hard.json")
    with open(path) as f:
        return json.load(f)


def family_recipe(family: str, epochs=None, n_train=None, n_val=None,
                  num_steps=None) -> dict:
    """The committed recipe, with the test overrides and n_val."""
    recipe = dict(committed(family)["recipe"])
    recipe["n_val"] = N_VAL
    for key, value in (("epochs", epochs), ("n_train", n_train), ("n_val", n_val),
                       ("num_steps_1", num_steps)):
        if value is not None:
            recipe[key] = int(value)
    if "awp_gamma" in recipe:
        recipe["num_steps_2"] = (AWP_EVAL_STEPS if num_steps is None
                                 else recipe["num_steps_1"])
    return recipe


def datasets(recipe: dict) -> tuple[ArrayDataset, ArrayDataset]:
    xs, ys = synthetic_hard_images(recipe["n_train"], seed=0)
    xv, yv = synthetic_hard_images(recipe["n_val"], seed=1)
    return ArrayDataset(xs, ys), ArrayDataset(xv, yv)


def step_lr(recipe: dict, epoch: int, i: int, n_batches: int) -> float:
    """The learning rate of minibatch i: AWP's fractional-epoch
    piecewise_50_75, else the recipe's constant lr."""
    if "awp_gamma" not in recipe:
        return float(recipe["lr"])
    return schedules.piecewise_50_75(float(recipe["lr"]), epoch + (i + 1) / n_batches,
                                     int(recipe["epochs"]))


def _to(x, y, device):
    """A host batch on the device: uint8 pixels, int64 labels."""
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device, torch.int64)


@torch.no_grad()
def torch_default_init(model: torch.nn.Module, seed: int) -> None:
    """torch's reset_parameters of every convolution and dense layer:
    weights kaiming-uniform with a = sqrt(5) (U(+-1/sqrt(fan_in))), biases
    U(+-1/sqrt(fan_in)); drawn on the CPU from a generator seeded with
    `seed`, so the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = torch.empty(m.weight.shape)
            torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(w[0].numel())
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound,
                                                                generator=gen))


def launches() -> dict:
    return {**ee_fused.LAUNCHES, **gemm_conv.LAUNCHES}


def run_seed(recipe: dict, seed: int, device: torch.device, train_ds, val_ds,
             init: str = "port") -> dict:
    """Train one seed; per-epoch clean and adversarial top-1 (percent,
    weighted by batch size), each step's lr, the kernel launches, steps,
    validation batches and wall seconds."""
    cfg = dict(recipe, seed=seed)
    ops, state, gen = build(cfg, NUM_CLASSES, device)
    if init == "torch":
        torch_default_init(state.model, seed)
    opt = OptimConfig(momentum=float(recipe["momentum"]),
                      weight_decay=float(recipe["weight_decay"]))
    method = make_method_config(cfg, NUM_CLASSES)
    awp = awp_config(cfg)
    if awp is None:
        train_step = build_train_step(ops, method, opt, gen)
    else:
        awp_step = build_awp_train_step(ops, method, opt, awp, gen)
    eval_steps = int(recipe.get("num_steps_2", recipe["num_steps_1"]))
    eval_step = build_eval_step(ops, eval_attack(cfg, NUM_CLASSES, num_steps=eval_steps),
                                gen)
    bs = int(recipe["batch_size"])
    n_batches = max(len(train_ds) // bs, 1)
    out = {"clean": [], "adv": [], "lr": [], "train_steps": 0, "eval_batches": 0}
    before = launches()
    t0 = time.perf_counter()
    for epoch in range(int(recipe["epochs"])):
        for i, (x, y) in enumerate(train_ds.batches(bs, shuffle=True, seed=seed,
                                                    epoch=epoch, as_uint8=True)):
            x, y = _to(x, y, device)
            lr = step_lr(recipe, epoch, i, n_batches)
            if awp is None:
                train_step(state, x, y, lr)
            else:
                awp_step(state, x, y, lr, 1.0 if epoch >= awp.warmup else 0.0)
            out["lr"].append(lr)
            out["train_steps"] += 1
        # validation draws from seed + 777 anew each epoch; the train
        # stream goes on where it stopped
        train_draws = gen.get_state()
        gen.manual_seed(seed + EVAL_SEED_OFFSET)
        clean = adv = n = 0.0
        for x, y in val_ds.batches(bs, shuffle=False, seed=0, as_uint8=True):
            m = eval_step(state, *_to(x, y, device))
            clean += float(m["clean_top1"]) * len(y)
            adv += float(m["adv_top1"]) * len(y)
            n += len(y)
            out["eval_batches"] += 1
        gen.set_state(train_draws)
        out["clean"].append(clean / n)
        out["adv"].append(adv / n)
        print(f"[twin {recipe['method_name']} seed {seed}] epoch {epoch}: clean "
              f"{out['clean'][-1]:.2f} adv {out['adv'][-1]:.2f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v - before[k] for k, v in launches().items() if v > before[k]}
    return out


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"type": device.type, "name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0]}


def run(family: str, seeds, device: str = "cuda", epochs=None, n_train=None,
        n_val=None, num_steps=None, init=None) -> dict:
    """Train every seed of a family (from the family's initialisation
    unless `init` names one); the family's record."""
    init = init or FAMILIES[family][2]
    dev = run_device({"device": device})
    recipe = family_recipe(family, epochs, n_train, n_val, num_steps)
    precision = pin_precision(recipe)
    train_ds, val_ds = datasets(recipe)
    return {"family": family, "twin": FAMILIES[family][0], "recipe": recipe,
            "seeds": list(seeds), "init": init,
            "port": {str(s): run_seed(recipe, s, dev, train_ds, val_ds, init)
                     for s in seeds},
            "device": device_record(dev), "precision": precision,
            "torch": torch.__version__}


def converged(hist: dict) -> dict:
    return {m: float(np.mean(hist[m][-CONVERGED_EPOCHS:])) for m in ("clean", "adv")}


def statistic(family: str, port: dict) -> dict:
    """The family's statistic: per metric each side's converged values,
    mean and seed range, the band, the gap to the JAX package's mean (and
    to the reference's, not gated), and whether gap <= band + MARGIN; the
    port's mid-band checks."""
    twin = committed(family)
    sides = {"port": port["port"], "jax": twin["ours"], "reference": twin["reference"]}
    seeds = {"port": port["seeds"], "jax": twin["seeds"], "reference": twin["seeds"]}
    out = {"family": family, "twin": FAMILIES[family][0], "margin": MARGIN}
    for m in ("clean", "adv"):
        row = {}
        for side, runs in sides.items():
            vals = [converged(runs[str(s)])[m] for s in seeds[side]]
            row[side] = {"vals": vals, "mean": float(np.mean(vals)),
                         "range": float(max(vals) - min(vals))}
        row["band"] = max(row[s]["range"] for s in sides)
        row["gap"] = abs(row["port"]["mean"] - row["jax"]["mean"])
        row["gap_reference"] = abs(row["port"]["mean"] - row["reference"]["mean"])
        row["pass"] = row["gap"] <= row["band"] + MARGIN
        out[m] = row
    clean, adv = out["clean"]["port"]["mean"], out["adv"]["port"]["mean"]
    clean_hi = FAMILIES[family][1]
    out["mid_band"] = {**MID_BAND, "clean_hi": clean_hi, "pass": bool(
        MID_BAND["lo"] <= clean <= clean_hi and adv <= clean - MID_BAND["attackable"]
        and adv >= MID_BAND["learnable"])}
    out["pass"] = bool(out["clean"]["pass"] and out["adv"]["pass"]
                       and out["mid_band"]["pass"])
    return out


def write_summary(out_dir: str) -> dict:
    """summary.json of every family whose record is in out_dir."""
    summary = {}
    for family in FAMILIES:
        path = os.path.join(out_dir, f"{family}.json")
        if os.path.exists(path):
            with open(path) as f:
                summary[family] = statistic(family, json.load(f))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="the port's whole-training twin")
    p.add_argument("--family", required=True, choices=sorted(FAMILIES))
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--epochs", type=int)
    p.add_argument("--n-train", type=int)
    p.add_argument("--n-val", type=int)
    p.add_argument("--num-steps", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--init", choices=["port", "torch"])
    p.add_argument("--out", default=os.path.join(REPO, "output", "twin_port"))
    a = p.parse_args(argv)
    record = run(a.family, a.seeds, a.device, a.epochs, a.n_train, a.n_val, a.num_steps,
                 a.init)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"{a.family}.json"), "w") as f:
        json.dump(record, f, indent=1)
    s = write_summary(a.out)[a.family]
    print(f"[twin {a.family}] clean gap {s['clean']['gap']:.2f} band "
          f"{s['clean']['band']:.2f}, adv gap {s['adv']['gap']:.2f} band "
          f"{s['adv']['band']:.2f}; pass {s['pass']}", flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
