"""Training driver of the port, as the repo-root train.py of the JAX package,
for the generic AT epoch loop:

    python -m edge_enhancement_tpu_torch.train \\
        --config edge_enhancement_tpu/configs/tiny_imagenet/ee_at_bpda3_square.yml \\
        --data synthetic --epochs 1 --limit-batches 3 --device cuda

Per epoch: the config's LR schedule, the train steps, the clean + PGD
validation, reference-format log lines (utils/meters.py)
and a torch.save checkpoint in the reference's dict format. Free-AT and
fast-AT run their own loop (`run_free_fast`, as the JAX train.py's): the
ImageNet recipes, e.g.

    python -m edge_enhancement_tpu_torch.train \
        --config edge_enhancement_tpu/configs/free_imagenet/free_at_ee.yml \
        --data synthetic --device cuda

AWP, --evaluate and --resume are not ported and raise.
"""

from __future__ import annotations

import functools
import math
import os
import shutil
import time

import torch

from ..data.datasets import get_dataset
from ..models.registry import build_model
from ..objectives.free_fast import (FreeFastConfig, build_fast_train_step,
                                   build_free_train_step, init_noise)
from ..objectives.methods import MethodConfig
from ..ops.square import add_square_draws
from ..utils.config import base_parser, load_config
from ..utils.meters import AverageMeter, adv_summary, clean_summary, train_line
from . import schedules
from .modelops import ModelOps
from .trainer import (EvalAttackConfig, OptimConfig, build_eval_step,
                      build_train_step, create_train_state)


class Logger:
    """print + append to <log_dir>/log.txt."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "log.txt")

    def __call__(self, msg: str):
        print(msg, flush=True)
        with open(self.path, "a") as f:
            print(msg, file=f)


def make_method_config(cfg) -> MethodConfig:
    return MethodConfig(
        method_name=cfg["method_name"],
        epsilon=float(cfg.get("epsilon", 8 / 255)),
        num_steps=int(cfg.get("num_steps_1", 10)),
        step_size=float(cfg.get("step_size_1", 2 / 255)),
        random=bool(cfg.get("random", True)),
        pre_square="pre_square" in cfg["method_name"])


def epoch_lr(cfg, epoch: float) -> float:
    """The config's learning rate at `epoch`: fractional for fast_knots,
    which the fast-AT loop evaluates every minibatch."""
    name = cfg.get("lr_schedule", "piecewise_50_75")
    lr0 = float(cfg["lr"])
    if name == "multistep":
        return schedules.multistep(lr0, epoch, tuple(cfg.get("milestones", (50, 80))))
    if name == "step30":
        return schedules.step30(lr0, epoch)
    if name == "piecewise_50_75":
        return schedules.piecewise_50_75(lr0, epoch, int(cfg["epochs"]))
    if name == "step30_free":
        return schedules.step30_free(lr0, int(epoch), int(cfg.get("n_repeats", 4)))
    if name == "fast_knots":
        # knots anchored at the phase start from the config, so a resumed
        # run follows the ramp of an uninterrupted one
        knots_e = cfg.get("lr_epochs") or [int(cfg.get("start_epoch", 0)),
                                           int(cfg["epochs"])]
        return schedules.interp_knots(epoch, knots_e,
                                      cfg.get("lr_values") or [lr0, lr0])
    raise NotImplementedError(f"lr_schedule {name!r}")


def _check_ported(cfg) -> None:
    if cfg.get("attack_method", "PGD") != "PGD":
        raise NotImplementedError(f"eval attack {cfg['attack_method']!r} is not ported")
    for key in ("awp_gamma", "evaluate", "resume", "pretrained", "profile",
                "platform"):
        if cfg.get(key):
            raise NotImplementedError(f"{key} is not ported")
    for key in ("restarts", "steps_per_dispatch"):
        if int(cfg.get(key) or 1) != 1:
            raise NotImplementedError(f"{key} > 1 is not ported")


def _device(cfg) -> torch.device:
    device = torch.device(cfg.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    return device


def run_validation(log, eval_step, state, ds, batch_size: int, device,
                   limit=None) -> tuple[float, float, int]:
    """Returns (adv top-1, or clean when no attack; clean top-1; batches)."""
    clean1, clean5, adv1, adv5 = (AverageMeter() for _ in range(4))
    n = 0
    for i, (x, y) in enumerate(ds.batches(batch_size, shuffle=False, seed=0,
                                          as_uint8=True)):
        if limit is not None and i >= limit:
            break
        m = eval_step(state, torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device))
        clean1.update(float(m["clean_top1"]), len(y))
        clean5.update(float(m["clean_top5"]), len(y))
        if "adv_top1" in m:
            adv1.update(float(m["adv_top1"]), len(y))
            adv5.update(float(m["adv_top5"]), len(y))
        n += 1
    log(clean_summary(clean1, clean5))
    if adv1.count:
        log(adv_summary(adv1, adv5))
    return (adv1.avg if adv1.count else clean1.avg), clean1.avg, n


def save_checkpoint(ckpt_dir: str, state, epoch: int, arch: str,
                    best_prec1: float, is_best: bool, opt: OptimConfig,
                    lr: float) -> str:
    """The reference's checkpoint dict {epoch, arch, state_dict, best_prec1,
    optimizer}, the optimizer part in torch.optim.SGD's state_dict format."""
    os.makedirs(ckpt_dir, exist_ok=True)
    n = len(state.momentum_buf)
    payload = {
        "epoch": epoch, "arch": arch,
        "state_dict": state.model.state_dict(), "best_prec1": best_prec1,
        "optimizer": {
            "state": {i: {"momentum_buffer": b}
                      for i, b in enumerate(state.momentum_buf)},
            "param_groups": [{"lr": lr, "momentum": opt.momentum,
                              "dampening": 0, "weight_decay": opt.weight_decay,
                              "nesterov": False, "params": list(range(n))}]},
    }
    path = os.path.join(ckpt_dir, "checkpoint.pth.tar")
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir, "model_best.pth.tar"))
    return path


class _Steps:
    """A training epoch's bookkeeping: the meters, the log line every
    `print_freq` steps and the seconds of each step (host clock around a
    step that ends in the loss read, which waits for the device)."""

    def __init__(self, log, epoch: int, n_batches: int, print_freq: int,
                 summary: dict):
        self.log, self.epoch, self.n_batches = log, epoch, n_batches
        self.print_freq, self.summary = print_freq, summary
        self.bt, self.dt, self.losses, self.top1, self.top5 = (
            AverageMeter() for _ in range(5))
        self.count, self.end = 0, time.time()

    def loaded(self):
        self.dt.update(time.time() - self.end)
        self.t0 = time.time()

    def done(self, i: int, m: dict, n: int) -> float:
        loss = float(m["loss"])                # waits for the step to finish
        self.summary["step_seconds"].append(time.time() - self.t0)
        self.count += 1
        self.losses.update(loss, n)
        self.top1.update(float(m["top1"]), n)
        self.top5.update(float(m["top5"]), n)
        self.bt.update(time.time() - self.end)
        if i % self.print_freq == 0:
            self.log(train_line(self.epoch, i, self.n_batches, self.bt, self.dt,
                                self.losses, self.top1, self.top5))
        self.end = time.time()
        return loss


def _batches(ds, batch_size: int, seed: int, epoch: int, limit):
    for i, (x, y) in enumerate(ds.batches(batch_size, shuffle=True, seed=seed,
                                          epoch=epoch, as_uint8=True)):
        if limit is not None and i >= limit:
            break
        yield i, x, y


def run(cfg) -> dict:
    """Drive one config; returns what the run did: train steps and eval
    batches per epoch, the last loss, per-step seconds, the checkpoint."""
    _check_ported(cfg)
    device = _device(cfg)
    dataset_name = cfg["dataset"]
    seed = int(cfg.get("seed", 1))
    image_size = cfg.get("cize") or cfg.get("crop_size")
    syn = cfg.get("synthetic_size")
    train_ds, spec = get_dataset(dataset_name, cfg.get("data"), train=True,
                                 image_size=image_size, synthetic_size=syn)
    val_ds, _ = get_dataset(dataset_name, cfg.get("data"), train=False,
                            image_size=image_size,
                            synthetic_size=syn // 2 if syn else None)
    num_classes = spec.num_classes

    # explicit generators: weights from a CPU generator (the same on every
    # device), the square draws and attack noise on the run's device
    init_gen = torch.Generator().manual_seed(seed)
    run_gen = torch.Generator(device=device).manual_seed(seed)
    model = build_model(cfg["arch"], cfg, num_classes,
                        square_source=functools.partial(add_square_draws,
                                                        generator=run_gen),
                        generator=init_gen).to(device)
    ops = ModelOps(model)
    state = create_train_state(model)

    run_name = (f"{cfg['method_name']}/{cfg['arch']}-bs{cfg['batch_size']}"
                f"-lr{cfg['lr']}-seed{seed}")
    out_dir = os.path.join(cfg.get("output", "output"), dataset_name, run_name)
    log = Logger(os.path.join(out_dir, "log"))
    log(f"=> dataset {dataset_name}, arch {cfg['arch']}, method "
        f"{cfg['method_name']}, device {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    summary = {"train_steps": [], "eval_batches": [], "step_seconds": [],
               "out_dir": out_dir}
    if cfg["method_name"] in ("free_AT", "fast_AT"):
        return run_free_fast(cfg, ops, state, train_ds, val_ds, log, summary,
                             run_gen, device)

    opt = OptimConfig(momentum=float(cfg.get("momentum", 0.9)),
                      weight_decay=float(cfg.get("weight_decay", 0.0)))
    train_step = build_train_step(ops, make_method_config(cfg), opt, run_gen)
    eval_step = build_eval_step(ops, EvalAttackConfig(
        epsilon=float(cfg.get("epsilon", 8 / 255)),
        num_steps=int(cfg.get("num_steps_1", 10)),
        step_size=float(cfg.get("step_size_1", 2 / 255)),
        random=bool(cfg.get("random", True))), run_gen)

    batch_size = int(cfg["batch_size"])
    limit = cfg.get("limit_batches")
    best_prec1, loss = 0.0, math.nan
    for epoch in range(int(cfg.get("start_epoch", 0)), int(cfg["epochs"])):
        lr = epoch_lr(cfg, epoch)
        steps = _Steps(log, epoch, len(train_ds) // batch_size,
                       int(cfg.get("print_freq", 50)), summary)
        for i, x, y in _batches(train_ds, batch_size, seed, epoch, limit):
            steps.loaded()
            m = train_step(state, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device), lr)
            loss = steps.done(i, m, len(y))
        prec1, _, n_eval = run_validation(log, eval_step, state, val_ds,
                                          batch_size, device, limit=limit)
        summary["train_steps"].append(steps.count)
        summary["eval_batches"].append(n_eval)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        summary["checkpoint"] = save_checkpoint(
            os.path.join(out_dir, "ckpt"), state, epoch + 1, cfg["arch"],
            best_prec1, is_best, opt, lr)
    log(f"=> done. best robust-eval Prec@1 {best_prec1:.3f}")
    summary.update(loss=loss, best_prec1=best_prec1)
    return summary


def run_free_fast(cfg, ops, state, train_ds, val_ds, log, summary: dict,
                  gen: torch.Generator, device) -> dict:
    """The free-AT / fast-AT loop, as the JAX train.py's run_free_fast.
    Free: the persistent noise, ceil(epochs / n_repeats) epochs, the
    step30_free LR. Fast: the noise redrawn every repeat, the fast_knots LR
    at epoch + (i n_repeats + 1) / n_batches for minibatch i, no decay on
    BatchNorm. Each epoch: the PGD validation and the checkpoint, with the
    replay noise saved beside it (ckpt/noise.pt)."""
    fast = cfg["method_name"] == "fast_AT"
    n_repeats = int(cfg.get("n_repeats", 1 if fast else 4))
    ffcfg = FreeFastConfig(
        n_repeats=n_repeats,
        fgsm_step=float(cfg.get("fgsm_step", 4.0)) / 255.0,
        clip_eps=float(cfg.get("clip_eps", 4.0)) / 255.0,
        random_init=bool(cfg.get("random_init", True)))
    opt = OptimConfig(momentum=float(cfg.get("momentum", 0.9)),
                      weight_decay=float(cfg.get("weight_decay", 1e-4)),
                      bn_no_decay=fast)
    step = (build_fast_train_step(ops, ffcfg, opt, gen) if fast
            else build_free_train_step(ops, ffcfg, opt))
    eval_step = build_eval_step(ops, EvalAttackConfig(
        epsilon=float(cfg.get("epsilon", ffcfg.clip_eps)),
        num_steps=int(cfg.get("num_steps_1", 10)),
        step_size=float(cfg.get("step_size_1", 1 / 255)),
        random=True), gen)
    # the schedule the JAX loop takes for the method, whatever lr_schedule says
    sched = dict(cfg, lr_schedule="fast_knots" if fast else "step30_free",
                 n_repeats=n_repeats)

    batch_size = int(cfg["batch_size"])
    channels = 1 if cfg["dataset"] == "mnist" else 3
    noise = init_noise(batch_size, int(cfg.get("cize", cfg.get("crop_size", 224))),
                       channels, device)
    epochs = int(cfg["epochs"]) if fast else math.ceil(int(cfg["epochs"]) / n_repeats)
    limit = cfg.get("limit_batches")
    n_batches = max(len(train_ds) // batch_size, 1)
    seed = int(cfg.get("seed", 1))
    best_prec1, loss = 0.0, math.nan
    ckpt_dir = os.path.join(summary["out_dir"], "ckpt")
    for epoch in range(int(cfg.get("start_epoch", 0)), epochs):
        steps = _Steps(log, epoch, n_batches, int(cfg.get("print_freq", 50)), summary)
        for i, x, y in _batches(train_ds, batch_size, seed, epoch, limit):
            lr = epoch_lr(sched, epoch + (i * n_repeats + 1) / n_batches if fast
                          else epoch)
            steps.loaded()
            noise, m = step(state, noise, torch.from_numpy(x).to(device),
                            torch.from_numpy(y).to(device), lr)
            loss = steps.done(i, m, len(y))
        prec1, _, n_eval = run_validation(log, eval_step, state, val_ds,
                                          batch_size, device, limit=limit)
        summary["train_steps"].append(steps.count)
        summary["eval_batches"].append(n_eval)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        summary["noise"] = os.path.join(ckpt_dir, "noise.pt")
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(noise.cpu(), summary["noise"])
        summary["checkpoint"] = save_checkpoint(
            ckpt_dir, state, epoch + 1, cfg["arch"], best_prec1, is_best, opt, lr)
    log(f"=> done. best robust-eval Prec@1 {best_prec1:.3f}")
    summary.update(loss=loss, best_prec1=best_prec1)
    return summary


def parser():
    p = base_parser("edge_enhancement_tpu_torch trainer")
    p.add_argument("--device", default=None,
                   help="torch device, e.g. cuda or cpu (default cuda); "
                        "cuda raises when CUDA is absent")
    return p


def main():
    args = parser().parse_args()
    cfg = load_config(args.config, vars(args))
    run(cfg)


if __name__ == "__main__":
    main()
