"""The chained train step: trainer.build_chained_train_step ->
train/graphs.py's ChainedTrainStep, K steps a dispatch (one train step
captured as a CUDA graph on a card and replayed K times), driven as the
driver's `_dispatch` drives it: K host batches stacked and copied to the
device in one copy each, one call, the loss read. The objective is the
configuration's method (driver.make_method_config), the optimizer its
SGD. Set-up runs the first three steps as dispatches of one batch each
(the first eager, with the capture; the next two replays): they are what
the comparison reads, and the warm-up."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import port
from benchmark.lib.cell import TrainBase, Unit, finite

from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, build_chained_train_step


class Path(TrainBase):
    trace_units = 1

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.k = int(self.traffic["steps_per_dispatch"])
        self.step_work = {"attack_iterations": int(self.cfg["num_steps_1"]), "train_passes": 1}
        self.lr = driver.epoch_lr(self.cfg, float(self.traffic["epoch"]))

    def setup(self) -> None:
        weights = self.weights()
        self.ops, self.state, self.gen = port.build(self.cfg, weights, self.seed, self.device)
        self.watch()
        opt = OptimConfig(momentum=float(self.cfg["momentum"]),
                          weight_decay=float(self.cfg["weight_decay"]))
        method = driver.make_method_config(self.cfg, int(self.cfg["num_classes"]))
        self.step = build_chained_train_step(self.ops, method, opt, self.gen)
        for k in range(self.first_steps):
            m = self._dispatch([self.take()])
            self.record_first(k, float(m["loss"]), weights)
        self.capture_seconds = self.step.capture_seconds

    def _dispatch(self, pending: list) -> dict:
        xs = torch.from_numpy(np.stack([x for x, _ in pending])).to(self.device)
        ys = torch.from_numpy(np.stack([y for _, y in pending])).to(self.device)
        return self.step(self.state, xs, ys, self.lr)

    def unit(self) -> Unit:
        t0 = time.perf_counter()
        m = self._dispatch([self.take() for _ in range(self.k)])
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        return Unit(self.k * self.batch, [dt / self.k] * self.k, finite(loss))
