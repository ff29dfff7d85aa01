"""What every entry's adapter (paths/<kind>.py) shares: the cell's
settings, its batch pool, its weights, the counts its metrics divide, and
the reference's side of the comparison that decides `correct`.

An adapter is a class `Path(cell, seed, device)` with
* `kind`: "train", the suffix of its split metric names;
* `setup()`: builds the program's object and drives it through the steps
  that the comparison reads, which warm it up;
* `unit()`: one call of the window (a dispatch, a step or a batch),
  ending in the read that waits for the device; returns a `Unit`;
* `trace_units`: the units in the traced span;
* `release()`: drops the program's state before the reference runs;
* `program_record()`: what the timed path produced that the comparison
  reads; `reference_record(precision, fault)`: the same from the reference
  put in the program's place (a control, or a planted fault);
  `judge(record)`: the numbers of such a record against the reference.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..reference import steps as R
from ..reference.resnet import ResNet, model_config
from . import batches, flops, spec
from .compare import leaf_norms, train_checks
from .weights import draw_seed, make_weights


@dataclasses.dataclass
class Unit:
    images: int            # images through the step(s)
    step_seconds: list     # host seconds of each step of the unit
    finite: bool           # the loss or metrics read were finite


class TrainBase:
    """A training entry: the comparison reads the first three steps of the
    object that the window then drives. A forward pre-hook on the program's
    model records the input of every forward (the attack's iterates and
    x_adv), so that the reference can follow the program's attack iteration
    by iteration: an eager forward's input is copied to the host at once;
    while a CUDA graph captures, the hook keeps the captured forward's
    input tensor itself (no copy, which keeps the graph's pool from reusing
    its memory), and after each replay of the set-up steps those tensors,
    which the replay wrote, are copied to the host. The hook and the kept
    tensors go before the window."""
    kind = "train"
    first_steps = 3
    trace_units = 1
    # what one step of an image runs (lib/flops.step_flops)
    step_work: dict = {}

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.model_cfg = model_config(self.cfg)
        self.precision = self.model_cfg["precision"]
        self.batch = int(self.traffic["batch_size"])
        self.size = int(self.cfg["cize"])
        self.limits = spec.load_json(os.path.join(cell.bench_dir, "limits",
                                                  cell.name + ".json"))["limits"]
        self.pool_x, self.pool_y = batches.make_pool(
            self.seed, int(self.traffic["pool_batches"]), self.batch, self.size,
            self.model_cfg["num_classes"], int(self.traffic.get("block", 8)),
            int(self.traffic.get("noise", 12)))
        self.next = 0

    # ---- inputs -----------------------------------------------------------
    def weights(self) -> dict:
        return make_weights(self.model_cfg, self.seed, self.device)

    def host_batch(self, i: int):
        n = len(self.pool_x)
        return self.pool_x[i % n], self.pool_y[i % n]

    def take(self):
        """The pool's next batch, cycling."""
        x, y = self.host_batch(self.next)
        self.next += 1
        return x, y

    def to_device(self, x, y):
        return torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device)

    def recipe(self) -> dict:
        """The recipe's values that the reference's steps read, from the
        configuration file (the YAML's keys)."""
        c = self.cfg
        return {"epsilon": float(c["epsilon"]), "step_size": float(c["step_size_1"]),
                "num_steps": int(c["num_steps_1"]), "momentum": float(c["momentum"]),
                "weight_decay": float(c["weight_decay"])}

    # ---- counts -------------------------------------------------------------
    def flops_per_image(self) -> float:
        fwd = flops.resnet_forward(self.model_cfg["depth"], self.size,
                                   self.model_cfg["num_classes"])
        return flops.step_flops(fwd, self.step_work)

    def ee_bound(self) -> dict:
        return flops.ee_fused_bound(self.batch, 3, self.size, self.size, self.precision,
                                    self.model_cfg["ee"]["square"])

    def release(self) -> None:
        for name in ("ops", "state", "step", "gen"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


    def watch(self) -> None:
        """Start recording the program's forward inputs of each step."""
        self.param_names = [n for n, _ in self.state.model.named_parameters()]
        self.prog = {"losses": [], "grad": None, "change": None, "inputs": []}
        self._seen, self._captured = [], []

        capturing = (torch.cuda.is_current_stream_capturing if self.device.type == "cuda"
                     else lambda: False)

        def hook(module, args):
            if capturing():
                self._captured.append(args[0].detach())
            else:
                self._seen.append(args[0].detach().to("cpu"))

        self._hook = self.state.model.register_forward_pre_hook(hook)

    def record_first(self, k: int, loss: float, weights: dict) -> None:
        """After step k (0-based) of the program, a dispatch of one step:
        its loss and forward inputs (a replay's from the captured tensors);
        after the first, the gradient as the optimizer got it (the momentum
        buffer less the decay term, the buffer having started at zero);
        after the last, the change of every parameter, and the hook and the
        captured tensors go."""
        if k == 0:
            wd = float(self.cfg["weight_decay"])
            self.prog["grad"] = leaf_norms(
                b - wd * weights[n] for n, b in zip(self.param_names, self.state.momentum_buf))
        self.prog["losses"].append(loss)
        replayed = k > 0 and not self._seen
        self.prog["inputs"].append([t.to("cpu") for t in self._captured] if replayed
                                   else self._seen)
        self._seen = []
        if k == self.first_steps - 1:
            self.prog["change"] = leaf_norms(
                p.detach() - weights[n]
                for n, p in zip(self.param_names, self.state.params))
            self._hook.remove()
            self._captured = []

    def program_record(self):
        return self.prog

    def reference_record(self, precision: str = None, fault: str = None,
                         follow: dict = None) -> dict:
        """The reference's three steps on the same batches, weights and
        draws, in float32, or with TF32 on where `precision` is "tf32" (the
        control), with `fault` ("half": the loss over half the batch).
        With `follow` (a record of the program, or of a control), every step
        follows its forward inputs (reference/steps.py; a step without them
        reads as infinitely far) and the record holds the worst start gap
        and flip share."""
        weights = self.weights()
        model = R.build(self.model_cfg, weights, draw_seed(self.seed), self.device)
        if [n for n, _ in model.named_parameters()] != self.param_names:
            raise RuntimeError("the reference's parameters differ from the program's")
        bufs = [torch.zeros_like(p) for p in model.parameters()]
        rec = self.recipe()
        out = {"losses": [], "inputs": [], "start_gap": 0.0, "flip_share": 0.0}
        with R.tf32(precision == "tf32"):
            for k in range(self.first_steps):
                x, y = self.to_device(*self.host_batch(k))
                given = [t.to(self.device) for t in follow["inputs"][k]] if follow else None
                r = R.at_step(model, bufs, x, y, rec, self.lr, given, fault == "half")
                out["losses"].append(float(r["loss"]))
                out["inputs"].append([t.to("cpu") for t in r["inputs"]])
                out["start_gap"] = max(out["start_gap"], r["start_gap"])
                out["flip_share"] = max(out["flip_share"], r["flip_share"])
                if k == 0:
                    out["grad"] = leaf_norms(r["grads"])
        out["change"] = leaf_norms(p.detach() - weights[n]
                                   for n, p in model.named_parameters())
        return out

    def judge(self, record: dict) -> list:
        """The numbers of `record` (the program's, or a control's) against
        the reference following it."""
        return train_checks(record, self.reference_record(follow=record), self.limits)

    def reference_names(self) -> list:
        """The parameter names of the reference's model, in order."""
        with torch.device("meta"):
            m = ResNet(self.model_cfg["depth"], self.model_cfg["num_classes"], self.model_cfg["ee"])
        return [n for n, _ in m.named_parameters()]


def finite(*values) -> bool:
    return all(math.isfinite(v) for v in values)
