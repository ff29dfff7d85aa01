"""Where two runs of the AutoAttack attacks part: APGD-CE, APGD-T (one
target), FAB-T and Square on a few noise images through the flagship model
(resnet18_EE_square), run twice on the same draws, in float32 and in
float64 on the CPU; prints each sample's share of x_adv pixels more than
1e-6 apart, its largest difference, and how many samples split (fail
`agrees`), for each of --sets sets of images:

    python -m edge_enhancement_tpu_torch.tools.attack_split [--sets 10] [--resume <ckpt>]

Without --resume the weights are the config's seeded initialisation. The
draws are replayed from seeded CPU generators (the attacks' draw functions
and the model's square source), so two runs differ only in their
arithmetic; a sample whose run takes another discrete decision (a step
halving, the max-loss point, an accepted square, FAB's backward step) on
values tied to rounding parts from there. chip_smoke.py runs the same
attacks on the card against the CPU (`replayed_attacks`), each forward and
input gradient of the card's runs held in lockstep against the CPU's at the
same input and draws (`Lockstep`)."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..attacks import autoattack as aa
from ..models.ee_frontend import ee_frontend
from ..models.registry import build_model
from ..ops.square import add_square_draws
from ..train.checkpoint import load_checkpoint
from ..train.modelops import ModelOps
from ..utils.config import load_config

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..", "edge_enhancement_tpu",
                      "configs", "tiny_imagenet", "ee_at_bpda3_square.yml")
_DRAWS = ("apgd_start", "square_stripes", "square_query_draws")
# A sample's two runs agree when at most XADV_SHARE of its pixels are more
# than 1e-6 apart (APGD, Square; the eval batteries' limit,
# tests/test_torch_eval.py XADV_SHARE) or, for FAB-T, whose steps land on a
# linearised boundary, when none is more than FAB_XADV_ATOL apart (1.6% of
# eps 16/255)
XADV_SHARE, FAB_XADV_ATOL = 0.01, 1e-3


def model_from_state(state: dict, cfg, square_source=None):
    """The config's model on the CPU with the weights of `state`."""
    model = build_model(cfg["arch"], cfg, state["fc.weight"].shape[0],
                        square_source=square_source)
    model.load_state_dict(state)
    return model


class Lockstep:
    """A forward `ops.logits_eval(x, draws)` held against `reference` (a
    ModelOps on the CPU) at each call, at the same input and draws: the
    largest logits difference over max(1, max |logit|). A call under
    autograd also holds two input gradients, each of a seeded random
    cotangent, by the norm of their difference over the reference's: the
    front-end's (K1/K2 on the card, the plain pair on the CPU) and the
    whole model's. The latter, one more backward through the caller's
    graph (kept for its own), also jumps where the backbone sits on a tie:
    a saturated (0 or 1) patch of the front-end's output makes equal
    convolution outputs, which a pooling window routes by position, and
    two convolution libraries round them apart."""

    def __init__(self, ops: ModelOps, reference: ModelOps):
        self.ops, self.reference = ops, reference
        self.gen = torch.Generator().manual_seed(7)
        self.forwards = self.gradients = 0
        self.logits_err = self.frontend_err = self.grad_norm_err = 0.0

    def _vjp(self, fn, x, draws, u):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x, draws), x, u.to(x.device, x.dtype))
        return g.cpu()

    def __call__(self, x, draws):
        out = self.ops.logits_eval(x, draws)
        grad = x.requires_grad and torch.is_grad_enabled()
        x_ref = x.detach().cpu().requires_grad_(grad)
        d_ref = None if draws is None else tuple(t.cpu() for t in draws)
        with torch.set_grad_enabled(grad):
            ref = self.reference.logits_eval(x_ref, d_ref)
        self.forwards += 1
        self.logits_err = max(self.logits_err, (out.detach().cpu() - ref.detach())
                              .abs().max().item() / max(1.0, ref.abs().max().item()))
        if not grad:
            return out
        self.gradients += 1
        r = torch.randn(ref.shape, generator=self.gen, dtype=ref.dtype)
        (g,) = torch.autograd.grad(out, x, r.to(out.device, out.dtype), retain_graph=True)
        (g_ref,) = torch.autograd.grad(ref, x_ref, r)
        self.grad_norm_err = max(self.grad_norm_err, _rel(g.cpu(), g_ref))
        ee = self.ops.model.ee
        if ee is not None:
            u = torch.randn(x.shape, generator=self.gen, dtype=x.dtype)
            front = lambda v, d: ee_frontend(v, ee, lambda shape: d)
            self.frontend_err = max(self.frontend_err, _rel(
                self._vjp(front, x, draws, u), self._vjp(front, x_ref, d_ref, u)))
        return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def clean_top2(state: dict, cfg, x: torch.Tensor, fixed) -> tuple:
    """(labels, targets): each image's two highest classes on the CPU under
    the square draws `fixed`, so every sample starts correct."""
    with torch.no_grad():
        logits = ModelOps(model_from_state(state, cfg)).logits_eval(x, fixed)
    order = torch.argsort(logits, dim=-1, stable=True)
    return order[:, -1], order[:, -2]


def replayed_attacks(state: dict, cfg, x, y, target, fixed, device,
                     dtype=torch.float32, steps: int = 5, queries: int = 20,
                     reference: ModelOps = None) -> dict:
    """name -> (x_adv as float64 on the CPU, misclassified under `fixed`,
    the attack's Lockstep against `reference` or None) for APGD-CE, APGD-T,
    FAB-T and Square on `device` in `dtype`, every draw from seeded CPU
    generators (float32 draws, moved and cast)."""
    eps = float(cfg["epsilon"])
    gen = torch.Generator().manual_seed(4)      # the attacks' draws
    sq = torch.Generator().manual_seed(5)       # the square source's
    real = {n: getattr(aa, n) for n in _DRAWS}

    def on(draws):
        return tuple(t.to(device) for t in draws)

    model = model_from_state(state, cfg, lambda shape: on(add_square_draws(shape, sq)))
    ops = ModelOps(model.to(device, dtype))
    fwd = {n: ops.logits_eval if reference is None else Lockstep(ops, reference)
           for n in ("apgd-ce", "apgd-t", "fab-t", "square")}
    xs, ys, ts = x.to(device, dtype), y.to(device), target.to(device)
    num_classes = state["fc.weight"].shape[0]
    acfg = aa.APGDConfig(eps, steps, num_classes)
    kw = dict(draw=ops.square_draws)
    aa.apgd_start = lambda xx, g: real["apgd_start"](xx.cpu().float(), gen).to(xx.device, xx.dtype)
    aa.square_stripes = lambda shape, g, d: real["square_stripes"](shape, gen, "cpu").to(d)
    aa.square_query_draws = lambda h, w, c, s, g, d: tuple(
        t.to(d) for t in real["square_query_draws"](h, w, c, s, gen, "cpu"))
    try:
        out = {"apgd-ce": aa.apgd(fwd["apgd-ce"], xs, ys, acfg, **kw),
               "apgd-t": aa.apgd(fwd["apgd-t"], xs, ys, acfg, y_target=ts, **kw),
               "fab-t": aa.fab_targeted(fwd["fab-t"], xs, ys, ts,
                                        aa.FABConfig(eps, steps), **kw),
               "square": aa.square_attack(fwd["square"], xs, ys, aa.SquareConfig(
                   eps, queries, num_classes=num_classes), **kw)}
    finally:
        for n, f in real.items():
            setattr(aa, n, f)
    with torch.no_grad():
        return {k: (v.cpu().double(),
                    (ops.logits_eval(v, on(fixed)).argmax(-1) != ys).cpu(),
                    None if reference is None else fwd[k])
                for k, v in out.items()}


def sample_diffs(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Per sample: the share of pixels more than 1e-6 apart, and the
    largest difference."""
    diff = (a - b).abs()
    return (diff > 1e-6).double().mean(dim=(1, 2, 3)), diff.amax(dim=(1, 2, 3))


def agrees(name: str, share: torch.Tensor, worst: torch.Tensor) -> torch.Tensor:
    """Per sample: whether two runs of attack `name` agree (see XADV_SHARE)."""
    return worst <= FAB_XADV_ATOL if name == "fab-t" else share <= XADV_SHARE


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resume", default=None, help="checkpoint dir or .pth file")
    p.add_argument("--sets", type=int, default=1, help="sets of images")
    p.add_argument("--n", type=int, default=8, help="images a set")
    p.add_argument("--size", type=int, default=64, help="image side")
    p.add_argument("--steps", type=int, default=5, help="APGD and FAB steps")
    p.add_argument("--queries", type=int, default=20, help="Square queries")
    args = p.parse_args(argv)
    cfg = load_config(CONFIG)
    if args.resume:
        payload = load_checkpoint(args.resume)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {args.resume}")
        state = payload["state_dict"]
    else:
        state = build_model(cfg["arch"], cfg, int(cfg["num_classes"]),
                            generator=torch.Generator().manual_seed(1)).state_dict()
    splits = {}
    for k in range(args.sets):
        x = torch.from_numpy(np.random.default_rng(2 + k).random(
            (args.n, args.size, args.size, 3)).astype(np.float32))
        fixed = add_square_draws(x.shape, torch.Generator().manual_seed(6))
        y, target = clean_top2(state, cfg, x, fixed)
        runs = {dt: replayed_attacks(state, cfg, x, y, target, fixed, "cpu", dt,
                                     args.steps, args.queries)
                for dt in (torch.float32, torch.float64)}
        for name, (a, wa, _) in runs[torch.float32].items():
            b, wb, _ = runs[torch.float64][name]
            share, worst = sample_diffs(a, b)
            split = int((~agrees(name, share, worst)).sum())
            splits.setdefault(name, []).append(split)
            print(f"set {k} {name}: float32 against float64, per sample: share of "
                  f"pixels more than 1e-6 apart {[round(v, 4) for v in share.tolist()]}, "
                  f"max |diff| {[float(f'{v:.3e}') for v in worst.tolist()]}; "
                  f"{split} of {args.n} split; misclassified {int(wa.sum())} / "
                  f"{int(wb.sum())}", flush=True)
    print(f"split samples a set, by attack: {splits}", flush=True)
    return splits


if __name__ == "__main__":
    main()
