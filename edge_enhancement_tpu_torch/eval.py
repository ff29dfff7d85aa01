"""Robustness evaluation of a trained model, as the JAX package's eval.py:
the PGD tiers num_steps_k/step_size_k (k = 1, 2, 3) of the config, FGSM
and CW-L-inf, each a battery over the validation split with the config's
validate() protocol (train/trainer.py::eval_protocol), and the AutoAttack
standard suite (APGD-CE, APGD-T, FAB-T, Square; attacks/autoattack.py):

    python -m edge_enhancement_tpu_torch.eval --config <cfg.yml> \\
        --resume <ckpt dir or .pth> --data <root> --suite pgd,fgsm,cw,aa

It loads the directory's best checkpoint, or its last when there is no
best. Each battery prints `<tag>: clean Prec@1 <a>  adv Prec@1 <b>` with
the JAX tags PGD-<K>, FGSM and CW-Linf-<iters>, then its time. The AA
suite reads the config keys aa_apgd_steps (100), aa_fab_steps (100),
aa_square_queries (1000), aa_target_classes (9) and aa_attacks (the
standard four; `apgd-dlr` adds the individual-mode APGD-DLR), runs on the
first aa_batches (--aa-batches, else --limit-batches) float batches of the
validation split, and prints `AutoAttack: clean Prec@1 <a>  robust Prec@1
<b>`, then its time. Runs on CUDA unless --device says otherwise.

Under torchrun (`torchrun --nproc_per_node N -m edge_enhancement_tpu_torch.eval
...`) each process attacks its rows of every global batch, as the JAX
eval.py's mesh-sharded batteries do, and the counts are summed over the
processes; rank 0 prints.
"""

from __future__ import annotations

import time

import torch

from .attacks.autoattack import STANDARD_ATTACKS, build_autoattack
from .parallel import mesh
from .train.checkpoint import load_checkpoint, restore_into_state
from .train.driver import (Logger, build, eval_attack, load_datasets,
                           pin_precision, run_device, run_validation)
from .train.driver import parser as train_parser
from .train.modelops import topk_accuracy
from .train.trainer import build_eval_step
from .utils.config import load_config
from .utils.meters import AverageMeter


def run(cfg) -> list:
    """Run the config's suite; returns one dict a battery: label, clean and
    adv top-1, batches, seconds, attack iterations a batch."""
    with mesh.torchrun_group(run_device(cfg)) as device:
        return _run(cfg, device)


def _run(cfg, device) -> list:
    suite = [s.strip() for s in str(cfg.get("suite", "pgd")).split(",")]
    precision = pin_precision(cfg)
    _, val_ds, spec = load_datasets(cfg, train=False)
    ops, state, gen = build(cfg, spec.num_classes, device)
    log = Logger(None)
    log(f"=> {cfg['arch']} on {device}, {precision}")
    if cfg.get("resume"):
        payload = (load_checkpoint(cfg["resume"], "best")
                   or load_checkpoint(cfg["resume"], "last"))
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {cfg['resume']}")
        state, epoch, _ = restore_into_state(state, payload)
        log(f"=> loaded checkpoint (epoch {epoch})")
    mesh.replicate(state.model)

    results = []

    def battery(attack, num_steps, step_size, label, **extra):
        es = build_eval_step(ops, eval_attack(
            cfg, spec.num_classes, attack_method=attack,
            epsilon=float(cfg["epsilon"]), num_steps=num_steps,
            step_size=step_size, **extra), gen)
        t0 = time.time()
        adv1, clean1, n = run_validation(lambda msg: None, es, state, val_ds,
                                         int(cfg["batch_size"]), device,
                                         limit=cfg.get("limit_batches"),
                                         by_rows=True)
        secs = time.time() - t0
        log(f"{label}: clean Prec@1 {clean1:.3f}  adv Prec@1 {adv1:.3f}")
        if n:
            log(f"   {n} batches in {secs:.2f} s, "
                f"{1e3 * secs / (n * num_steps):.2f} ms per attack iteration")
        results.append({"label": label, "clean_top1": clean1, "adv_top1": adv1,
                        "batches": n, "seconds": secs, "iterations": num_steps})

    if "pgd" in suite:
        for tier in ("1", "2", "3"):
            ns = cfg.get(f"num_steps_{tier}")
            if ns is None:
                continue
            ss = float(cfg[f"step_size_{tier}"])
            battery("PGD", int(ns), ss, f"PGD-{ns}")
    if "fgsm" in suite:
        battery("FGSM", 1, float(cfg.get("step_size_1", 2 / 255)), "FGSM")
    if "cw" in suite:
        cw_iters = int(cfg.get("cw_iters", 20))
        battery("CW", cw_iters, 0.00392, f"CW-Linf-{cw_iters}",
                cw_iters=cw_iters)
    if "aa" in suite:
        results.append(autoattack(cfg, ops, val_ds, spec.num_classes, device,
                                  gen, log))
    return results


def autoattack(cfg, ops, val_ds, num_classes: int, device, gen, log) -> dict:
    """The AutoAttack battery, as the JAX eval.py's: the suite on each of
    the first `aa_batches` (else `limit_batches`) float batches, then the
    clean and the adversarial top-1 under one square draw, each process on
    its rows of the batch and the top-1 the global batch's. `iterations` is
    the suite's attack iterations a batch: the APGD and FAB steps and the
    Square queries of every attack it runs."""
    attacks = tuple(a.strip() for a in str(
        cfg.get("aa_attacks", ",".join(STANDARD_ATTACKS))).split(","))
    steps = dict(apgd_steps=int(cfg.get("aa_apgd_steps", 100)),
                 fab_steps=int(cfg.get("aa_fab_steps", 100)),
                 square_queries=int(cfg.get("aa_square_queries", 1000)),
                 n_target_classes=int(cfg.get("aa_target_classes", 9)))
    suite = build_autoattack(ops.logits_eval, epsilon=float(cfg["epsilon"]),
                             num_classes=num_classes, attacks_to_run=attacks,
                             draw=ops.square_draws, **steps)
    n_tc = max(1, min(steps["n_target_classes"], num_classes - 1))
    iterations = (steps["apgd_steps"] * (("apgd-ce" in attacks) + ("apgd-dlr" in attacks)
                                         + n_tc * ("apgd-t" in attacks))
                  + steps["fab_steps"] * n_tc * ("fab-t" in attacks)
                  + steps["square_queries"] * ("square" in attacks))
    cap = cfg.get("aa_batches") or cfg.get("limit_batches")
    c1, a1 = AverageMeter(), AverageMeter()
    n, t0 = 0, time.time()
    for i, (x, y) in enumerate(val_ds.batches(int(cfg["batch_size"]),
                                              shuffle=False, seed=0)):
        if cap is not None and i >= cap:
            break
        n_glob = len(y)
        x = mesh.shard_rows(torch.from_numpy(x)).to(device)
        y = mesh.shard_rows(torch.from_numpy(y)).to(device).long()
        x_adv = suite(x, y, gen)
        with torch.no_grad():
            draws = ops.square_draws(x)
            top1 = mesh.sum_metrics({
                "clean": topk_accuracy(ops.logits_eval(x, draws), y)["top1"],
                "adv": topk_accuracy(ops.logits_eval(x_adv, draws), y)["top1"]})
        c1.update(float(top1["clean"]), n_glob)
        a1.update(float(top1["adv"]), n_glob)
        n += 1
    secs = time.time() - t0
    log(f"AutoAttack: clean Prec@1 {c1.avg:.3f}  robust Prec@1 {a1.avg:.3f}")
    if n:
        log(f"   {n} batches in {secs:.2f} s, {secs / n:.2f} s a batch, "
            f"{1e3 * secs / (n * max(iterations, 1)):.2f} ms per attack iteration")
    return {"label": "AutoAttack", "clean_top1": c1.avg, "adv_top1": a1.avg,
            "batches": n, "seconds": secs, "iterations": iterations}


def parser():
    p = train_parser("edge_enhancement_tpu_torch robustness evaluation")
    p.add_argument("--suite", default="pgd",
                   help="comma list of pgd, fgsm, cw, aa")
    p.add_argument("--aa-batches", type=int, default=None,
                   help="cap AA to first N batches")
    p.add_argument("--aa-attacks", default=",".join(STANDARD_ATTACKS),
                   help="AA subset (reference 'individual' mode); "
                        "default is the 4-attack standard suite")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    run(load_config(args.config, vars(args)))


if __name__ == "__main__":
    main()
