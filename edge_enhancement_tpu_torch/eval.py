"""Robustness evaluation of a trained model, as the JAX package's eval.py:
the PGD tiers num_steps_k/step_size_k (k = 1, 2, 3) of the config, FGSM
and CW-L-inf, each a battery over the validation split with the config's
validate() protocol (train/trainer.py::eval_protocol):

    python -m edge_enhancement_tpu_torch.eval --config <cfg.yml> \\
        --resume <ckpt dir or .pth> --data <root> --suite pgd,fgsm,cw

It loads the directory's best checkpoint, or its last when there is no
best. Each battery prints `<tag>: clean Prec@1 <a>  adv Prec@1 <b>` with
the JAX tags PGD-<K>, FGSM and CW-Linf-<iters>, then its time. The
AutoAttack suite (`aa`) is not ported. Runs on CUDA unless --device says
otherwise.
"""

from __future__ import annotations

import time

from .train.checkpoint import load_checkpoint, restore_into_state
from .train.driver import (Logger, build, eval_attack, load_datasets,
                           run_device, run_validation)
from .train.driver import parser as train_parser
from .train.trainer import build_eval_step
from .utils.config import load_config


def run(cfg) -> list:
    """Run the config's suite; returns one dict a battery: label, clean and
    adv top-1, batches, seconds, attack iterations a batch."""
    suite = [s.strip() for s in str(cfg.get("suite", "pgd")).split(",")]
    if "aa" in suite:
        raise NotImplementedError("the AutoAttack suite (aa) is not ported "
                                  "(ROADMAP Queue 1, M18)")
    device = run_device(cfg)
    _, val_ds, spec = load_datasets(cfg, train=False)
    ops, state, gen = build(cfg, spec.num_classes, device)
    log = Logger(None)
    if cfg.get("resume"):
        payload = (load_checkpoint(cfg["resume"], "best")
                   or load_checkpoint(cfg["resume"], "last"))
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {cfg['resume']}")
        state, epoch, _ = restore_into_state(state, payload)
        log(f"=> loaded checkpoint (epoch {epoch})")

    results = []

    def battery(attack, num_steps, step_size, label, **extra):
        es = build_eval_step(ops, eval_attack(
            cfg, spec.num_classes, attack_method=attack,
            epsilon=float(cfg["epsilon"]), num_steps=num_steps,
            step_size=step_size, **extra), gen)
        t0 = time.time()
        adv1, clean1, n = run_validation(lambda msg: None, es, state, val_ds,
                                         int(cfg["batch_size"]), device,
                                         limit=cfg.get("limit_batches"))
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
    return results


def parser():
    p = train_parser("edge_enhancement_tpu_torch robustness evaluation")
    p.add_argument("--suite", default="pgd",
                   help="comma list of pgd, fgsm, cw (aa is not ported)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    run(load_config(args.config, vars(args)))


if __name__ == "__main__":
    main()
