"""Training driver of the port, as the repo-root train.py of the JAX package,
for the generic AT epoch loop:

    python -m edge_enhancement_tpu_torch.train \\
        --config edge_enhancement_tpu/configs/tiny_imagenet/ee_at_bpda3_square.yml \\
        --data synthetic --epochs 1 --limit-batches 3 --device cuda

Per epoch: the config's LR schedule, the train steps, the clean + PGD
validation, reference-format log lines (utils/meters.py)
and a torch.save checkpoint in the reference's dict format. Free-AT,
fast-AT, AWP, --evaluate and --resume are not ported and raise.
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


def epoch_lr(cfg, epoch: int) -> float:
    name = cfg.get("lr_schedule", "piecewise_50_75")
    lr0 = float(cfg["lr"])
    if name == "multistep":
        return schedules.multistep(lr0, epoch, tuple(cfg.get("milestones", (50, 80))))
    if name == "step30":
        return schedules.step30(lr0, epoch)
    if name == "piecewise_50_75":
        return schedules.piecewise_50_75(lr0, epoch, int(cfg["epochs"]))
    raise NotImplementedError(f"lr_schedule {name!r}")


def _check_ported(cfg) -> None:
    if cfg["method_name"] in ("free_AT", "fast_AT"):
        raise NotImplementedError(f"{cfg['method_name']} is not ported")
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
    print_freq = int(cfg.get("print_freq", 50))
    best_prec1, loss = 0.0, math.nan
    summary = {"train_steps": [], "eval_batches": [], "step_seconds": [],
               "out_dir": out_dir}
    for epoch in range(int(cfg.get("start_epoch", 0)), int(cfg["epochs"])):
        lr = epoch_lr(cfg, epoch)
        bt, dt, losses, top1, top5 = (AverageMeter() for _ in range(5))
        n_batches = len(train_ds) // batch_size
        steps = 0
        end = time.time()
        for i, (x, y) in enumerate(train_ds.batches(
                batch_size, shuffle=True, seed=seed, epoch=epoch,
                as_uint8=True)):
            if limit is not None and i >= limit:
                break
            dt.update(time.time() - end)
            t0 = time.time()
            m = train_step(state, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device), lr)
            loss = float(m["loss"])            # waits for the step to finish
            summary["step_seconds"].append(time.time() - t0)
            steps += 1
            losses.update(loss, len(y))
            top1.update(float(m["top1"]), len(y))
            top5.update(float(m["top5"]), len(y))
            bt.update(time.time() - end)
            if i % print_freq == 0:
                log(train_line(epoch, i, n_batches, bt, dt, losses, top1, top5))
            end = time.time()
        prec1, _, n_eval = run_validation(log, eval_step, state, val_ds,
                                          batch_size, device, limit=limit)
        summary["train_steps"].append(steps)
        summary["eval_batches"].append(n_eval)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        summary["checkpoint"] = save_checkpoint(
            os.path.join(out_dir, "ckpt"), state, epoch + 1, cfg["arch"],
            best_prec1, is_best, opt, lr)
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
