"""The numbers that decide `correct`, each compared with its limit.

A training cell compares, over the first three steps of the very object
that the window then drives, with the reference following the program's
attack (its eager steps' and its replays' forward inputs alike): the
share of pixels whose iterate the program and the reference decide
differently (`flip_share`: the first iterate from the reference's own
start, every later one from the program's iterate before it); each
step's loss (`loss_gap`, the largest relative gap); the first step's
gradient as the optimizer got it (`grad_gap`) and the parameters' change
over the three (`change_gap`), both by the worst leaf: the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of the change. `start_gap`, how far the program's
start lies from the reference's, and `still_leaves`, how many leaves were
left out, are readings beside them."""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

STILL = 1e-3     # a leaf whose gradient is under this share of the median leaf's


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def leaf_gap(prog: list, ref: list, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median(ref)), over the
    leaves that `keep` marks (all by default)."""
    med = statistics.median(ref)
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if any(not math.isfinite(prog[i]) for i in idx):
        return math.inf
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def moving(ref_grad_norms: list) -> list:
    """Which leaves the reference's gradient moves beyond round-off."""
    med = statistics.median(ref_grad_norms)
    return [n >= STILL * med for n in ref_grad_norms]


def train_numbers(prog: dict, ref: dict) -> dict:
    """Every number a training cell can compare. `prog`: the program's
    record (or a control's); `ref`: the reference's record following it
    (lib/cell.TrainBase.reference_record): per step the loss, the first
    step's leaf norms of the gradient, the leaf norms of the change over
    the three steps."""
    keep = moving(ref["grad"])
    return {
        "start_gap": ref["start_gap"],
        "flip_share": ref["flip_share"],
        "loss_gap": max((rel_gap(prog["losses"][k], ref["losses"][k])
                         if math.isfinite(prog["losses"][k]) else math.inf)
                        for k in range(len(ref["losses"]))),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], keep),
        "still_leaves": keep.count(False),
    }


def train_checks(prog: dict, ref: dict, limits: dict) -> list:
    """The numbers that the cell's limits name, each with its limit."""
    numbers = train_numbers(prog, ref)
    return [Check(name, numbers[name], limit) for name, limit in limits.items()]
