"""Whole-training twin of the port: the committed twin recipes of the JAX
package (`output/twin_hard*/twin_hard.json`) trained end to end by the
port, seed by seed, and held at convergence against the committed runs.

    python -m edge_enhancement_tpu_torch.tools.twin --family flagship \\
        --seeds 1 2 3 [--device cpu] [--out output/twin_port]

Families and the committed run each reads its recipe from (never retyped):
flagship -> twin_hard (resnet18_EE_square, EE_BPDA3_AT_square), tar ->
twin_hard_tar (targeted), trades -> twin_hard_trades, alp ->
twin_hard_alp (resnet18), awp -> twin_hard_awp (PreActResNet18_EE_BPDA_3,
EE_AT_AWP), free -> twin_hard_free (resnet18_EE with the full CannyFilter,
free-AT's replay loop), fast -> twin_hard_fast (resnet50_EE, fast-AT), fd
-> twin_hard_fd (resnet18_fd, tarFD), trick -> twin_hard_trick
(resnet18_EE with the full CannyFilter, tarEE_trick). A run is float32
with TF32 off (`driver.pin_precision`) in single eager steps on CUDA, or
on the CPU with --device cpu (no fallback).

Each seed: `synthetic_hard_images(n_train, seed=0)` trains and `(n_val,
seed=1)` validates; the train batches are `ArrayDataset.batches(25,
shuffle=True, seed=seed, epoch=epoch)`, the JAX package's stream, so a
seed's batch order is the committed run's. The committed runs started from
the PyTorch reference's initialisation, converted, which is not in the
repo: the comparison is unpaired and made at convergence, not step by
step. A seed starts from weights drawn on the CPU from a generator seeded
with the seed and moved to the device, so the same on the card and on the
CPU, from the distribution of the committed runs' reference model
(FAMILIES): for the ResNet families (Tiny-ImageNet resnet18 and
resnet18_EE_square; ImageNet resnet18_EE, resnet50_EE, resnet18_fd)
"reference", the init of the reference's torchvision-style ResNets: the
convolution weights and BatchNorms as the port's own initialisation draws
them (`models/resnet.py::init_weights`, the JAX package's, whose init
follows the reference ResNet's init loop:
`edge_enhancement_tpu/models/resnet.py:6-7`), the dense head and the
convolution biases at torch's defaults, which that loop leaves (from the
port's own head the free family's adversarial accuracy converged above
every JAX seed's: output/twin_port/port_init/); for AWP torch's default
initialisation (`torch_default_init`), which the reference PreActResNet
keeps, where the port's and the JAX package's PreActResNet draw their
convolutions from the ResNet's N(0, 2/fan_out), 2.46x the default's
spread, and on this recipe converge lower (--init port;
output/twin_port/port_init/).

The training loop is the family's JAX tool's: `generic` (one
`build_train_step` a batch at the recipe's constant lr), `awp`
(`piecewise_50_75` at epoch + (i + 1) / n_batches every minibatch, the gate
on from `awp_warmup`), `free` (`build_free_train_step`: each batch replayed
n_repeats times inside the step, one noise buffer carried across batches
and epochs, `step30_free` set once an epoch; `epochs` are outer epochs)
and `fast` (`build_fast_train_step`: FGSM from a uniform start redrawn
each batch, no weight decay on BatchNorm, the lr interpolated over the
recipe's knots [0, lr_peak, lr_peak / 10] at epoch + (i + 1) / n_batches,
n_batches rounded up). Every epoch validates with PGD (the family's
`eval_steps`, else the recipe's `num_steps_1`; the recipe's epsilon and
`step_size_1`, random start; targeted for tar* methods) on draws seeded
seed + 777 anew each epoch, as the committed runs' eval key; the train
steps draw from a generator seeded with the seed.

The statistic (`statistic`, written to <out>/summary.json): converged = the
mean of the last 2 epochs; for clean and adversarial top-1, gap =
|mean(port) - mean(JAX)| over the seeds, band = the largest seed range of
the reference's, the JAX package's and the port's runs (each an
independent draw of the recipe's noise); a family passes when gap <= band
+ 1.0 and the port's means are mid-band (MID_BAND). The gap to the
reference's mean is reported beside it.

--epochs, --n-train, --n-val and --num-steps (the train and validation
attack's steps) shrink a run for tests; --init port|torch|reference
overrides the family's initialisation (reference: the port's
convolutions and BatchNorms, torch's default dense head and convolution
biases, as a torchvision-style ResNet's init loop leaves them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from ..data.datasets import ArrayDataset, synthetic_hard_images
from ..objectives.awp import build_awp_train_step
from ..objectives.free_fast import (FreeFastConfig, build_fast_train_step,
                                    build_free_train_step, init_noise)
from ..ops.cuda import ee_fused, gemm_conv
from ..train import schedules
from ..train.driver import (awp_config, build, eval_attack, make_method_config,
                            pin_precision, run_device)
from ..train.trainer import OptimConfig, build_eval_step, build_train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Family:
    """A twin family: its committed twin directory under output/, the
    committed gate's upper bound on the converged clean mean
    (tests/test_digital_twin_tiny.py), the initialisation of the committed
    runs' reference model, the head's class count (the Tiny-ImageNet heads
    200; the ImageNet models' hard-wired 1000, tools/digital_twin_{free,
    fast,fd,trick}.py), the training loop and the validation PGD's steps
    (None: the recipe's num_steps_1)."""
    twin: str
    clean_hi: float
    init: str                      # port | torch | reference (torch_default_init)
    num_classes: int = 200
    loop: str = "generic"          # generic | awp | free | fast
    eval_steps: int | None = None


# Initialisation. The ResNet families "reference": the reference's
# torchvision-style ResNets (SURVEY.md:147-153) draw their convolution
# weights N(0, 2/fan_out) and BatchNorms 1/0 in an init loop, as the JAX
# package's conv_init and so the port's do
# (edge_enhancement_tpu/models/resnet.py:6-7, 35), and leave the dense head
# and the convolution biases (the denoising blocks') at torch's defaults.
# AWP "torch": the reference PreActResNet keeps torch's defaults.
# eval_steps: AWP's is ee_bpda_3_at_awp.yml's num_steps_2, free's and
# fast's the JAX tools' EVAL_STEPS (their recipes train with no PGD).
FAMILIES = {"flagship": Family("twin_hard", 95.0, "reference"),
            "tar": Family("twin_hard_tar", 95.0, "reference"),
            "trades": Family("twin_hard_trades", 97.0, "reference"),
            "alp": Family("twin_hard_alp", 95.0, "reference"),
            "awp": Family("twin_hard_awp", 95.0, "torch", loop="awp", eval_steps=20),
            "free": Family("twin_hard_free", 98.0, "reference", 1000, "free", 10),
            "fast": Family("twin_hard_fast", 96.0, "reference", 1000, "fast", 10),
            "fd": Family("twin_hard_fd", 96.0, "reference", 1000),
            "trick": Family("twin_hard_trick", 96.0, "reference", 1000)}
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
    path = os.path.join(REPO, "output", FAMILIES[family].twin, "twin_hard.json")
    with open(path) as f:
        return json.load(f)


def family_recipe(family: str, epochs=None, n_train=None, n_val=None,
                  num_steps=None) -> dict:
    """The committed recipe, with the test overrides, n_val and (where the
    family sets them) the validation PGD's steps as num_steps_2.
    `num_steps` sets the training attack's steps where the loop has one
    (not free's or fast's) and the validation attack's."""
    fam = FAMILIES[family]
    recipe = dict(committed(family)["recipe"])
    recipe["n_val"] = N_VAL
    for key, value in (("epochs", epochs), ("n_train", n_train), ("n_val", n_val)):
        if value is not None:
            recipe[key] = int(value)
    if num_steps is not None and fam.loop in ("generic", "awp"):
        recipe["num_steps_1"] = int(num_steps)
    if fam.eval_steps is not None:
        recipe["num_steps_2"] = fam.eval_steps if num_steps is None else int(num_steps)
    return recipe


def datasets(recipe: dict) -> tuple[ArrayDataset, ArrayDataset]:
    xs, ys = synthetic_hard_images(recipe["n_train"], seed=0)
    xv, yv = synthetic_hard_images(recipe["n_val"], seed=1)
    return ArrayDataset(xs, ys), ArrayDataset(xv, yv)


def n_batches(loop: str, recipe: dict, n: int) -> int:
    """The minibatches an epoch that the lr schedule divides by: fast-AT's
    rounded up (the reference's len(loader)), else the steps an epoch."""
    bs = int(recipe["batch_size"])
    return math.ceil(n / bs) if loop == "fast" else max(n // bs, 1)


def step_lr(loop: str, recipe: dict, epoch: int, i: int, n_batches: int) -> float:
    """The learning rate of minibatch i of `epoch`: AWP's fractional-epoch
    piecewise_50_75, free-AT's step30_free of the (outer) epoch, fast-AT's
    knots [0, lr_peak, lr_peak / 10] at epoch + (i + 1) / n_batches, else
    the recipe's constant lr."""
    if loop == "awp":
        return schedules.piecewise_50_75(float(recipe["lr"]), epoch + (i + 1) / n_batches,
                                         int(recipe["epochs"]))
    if loop == "free":
        return schedules.step30_free(float(recipe["lr"]), epoch, int(recipe["n_repeats"]))
    if loop == "fast":
        peak = float(recipe["lr_peak"])
        return schedules.interp_knots(epoch + (i + 1) / n_batches, recipe["lr_epochs"],
                                      [0.0, peak, peak / 10])
    return float(recipe["lr"])


def optim_config(loop: str, recipe: dict) -> OptimConfig:
    """SGD's settings: fast-AT decays no BatchNorm parameter
    (tools/digital_twin_fast.py, the reference's main_fast.py)."""
    return OptimConfig(momentum=float(recipe["momentum"]),
                       weight_decay=float(recipe["weight_decay"]),
                       bn_no_decay=loop == "fast")


def free_fast_config(recipe: dict) -> FreeFastConfig:
    """Free-AT's and fast-AT's replay settings; the recipes store fgsm_step
    and clip_eps divided by 255 already."""
    return FreeFastConfig(n_repeats=int(recipe["n_repeats"]),
                          fgsm_step=float(recipe["fgsm_step"]),
                          clip_eps=float(recipe["clip_eps"]),
                          random_init=bool(recipe.get("random_init", True)))


def _to(x, y, device):
    """A host batch on the device: uint8 pixels, int64 labels."""
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device, torch.int64)


@torch.no_grad()
def torch_default_init(model: torch.nn.Module, seed: int, conv_weights: bool = True) -> None:
    """torch's reset_parameters of every convolution and dense layer:
    weights kaiming-uniform with a = sqrt(5) (U(+-1/sqrt(fan_in))), biases
    U(+-1/sqrt(fan_in)); drawn on the CPU from a generator seeded with
    `seed`, so the same on every device. Without `conv_weights` the
    convolutions keep their weights (the draws are made all the same) and
    only their biases and the dense layers take torch's defaults: a
    torchvision-style ResNet's init loop draws the convolution weights and
    the BatchNorms alone (--init reference)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = torch.empty(m.weight.shape)
            torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
            if conv_weights or isinstance(m, torch.nn.Linear):
                m.weight.copy_(w)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(w[0].numel())
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound,
                                                                generator=gen))


def launches() -> dict:
    return {**ee_fused.LAUNCHES, **gemm_conv.LAUNCHES}


def run_seed(family: str, recipe: dict, seed: int, device: torch.device, train_ds,
             val_ds, init: str = "port") -> dict:
    """Train one seed in the family's loop; per-epoch clean and adversarial
    top-1 (percent, weighted by batch size), each step's lr, the kernel
    launches, train steps (batches), SGD updates (free-AT's replays
    count), validation batches and wall seconds."""
    fam = FAMILIES[family]
    cfg = dict(recipe, seed=seed)
    ops, state, gen = build(cfg, fam.num_classes, device)
    if init in ("torch", "reference"):
        torch_default_init(state.model, seed, conv_weights=init == "torch")
    opt = optim_config(fam.loop, recipe)
    awp = awp_config(cfg)
    noise = None
    if fam.loop in ("free", "fast"):
        ffcfg = free_fast_config(recipe)
        step = (build_free_train_step(ops, ffcfg, opt) if fam.loop == "free"
                else build_fast_train_step(ops, ffcfg, opt, gen))
        # the replay buffer: free-AT carries it across batches and epochs,
        # fast-AT redraws it each batch
        noise = init_noise(int(recipe["batch_size"]), int(recipe["cize"]), device=device)
    else:
        method = make_method_config(cfg, fam.num_classes)
        step = (build_train_step(ops, method, opt, gen) if awp is None
                else build_awp_train_step(ops, method, opt, awp, gen))
    eval_steps = int(recipe["num_steps_2"] if "num_steps_2" in recipe
                     else recipe["num_steps_1"])
    eval_step = build_eval_step(
        ops, eval_attack(cfg, fam.num_classes, num_steps=eval_steps), gen)
    bs = int(recipe["batch_size"])
    per_epoch = n_batches(fam.loop, recipe, len(train_ds))
    out = {"clean": [], "adv": [], "lr": [], "train_steps": 0, "eval_batches": 0}
    before = launches()
    step0 = state.step
    t0 = time.perf_counter()
    for epoch in range(int(recipe["epochs"])):
        for i, (x, y) in enumerate(train_ds.batches(bs, shuffle=True, seed=seed,
                                                    epoch=epoch, as_uint8=True)):
            x, y = _to(x, y, device)
            lr = step_lr(fam.loop, recipe, epoch, i, per_epoch)
            if noise is not None:
                noise, _ = step(state, noise, x, y, lr)
            elif awp is not None:
                step(state, x, y, lr, 1.0 if epoch >= awp.warmup else 0.0)
            else:
                step(state, x, y, lr)
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
    out["updates"] = int(state.step - step0)
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
    init = init or FAMILIES[family].init
    dev = run_device({"device": device})
    recipe = family_recipe(family, epochs, n_train, n_val, num_steps)
    precision = pin_precision(recipe)
    train_ds, val_ds = datasets(recipe)
    return {"family": family, "twin": FAMILIES[family].twin, "recipe": recipe,
            "seeds": list(seeds), "init": init,
            "port": {str(s): run_seed(family, recipe, s, dev, train_ds, val_ds, init)
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
    out = {"family": family, "twin": FAMILIES[family].twin, "margin": MARGIN}
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
    clean_hi = FAMILIES[family].clean_hi
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
    p.add_argument("--init", choices=["port", "torch", "reference"])
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
