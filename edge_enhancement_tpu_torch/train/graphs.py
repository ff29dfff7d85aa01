"""K train steps a dispatch, the port's counterpart of the JAX package's
build_chained_train_step (edge_enhancement_tpu/train/trainer.py), which
runs the K steps as one lax.scan over a stack of K batches, on any mesh.
Here the same K steps run with one host synchronisation, in one of two
forms (`chained_form`), which the driver's first log line names:

* graph: a replayed CUDA graph of one train step, on a CUDA device with
  one rank, or under NCCL with any number: the step's all-reduces
  (parallel/mesh.py) are captured with it.
* loop: the step called K times, on the CPU under any group, and on a
  CUDA device under gloo, whose collectives cannot be captured.

The graph form. The run's first step runs eagerly: a real step, which also
builds every lazy constant (the kernels' libraries and operators, the
pixel scale, cuBLAS's handle) and, under NCCL, creates the groups'
communicators (a group makes its own at its first collective, and a
capture cannot). Then one train step is captured on static buffers: one
batch (x, y) and the learning rate, a 0-dim tensor filled before each
dispatch, so a replay follows the epoch's rate without a new capture.
Every later step is a device-to-device copy into the buffers and one
replay; a tail chain is fewer replays, and a run captures once. The graph
updates the model's parameters, BatchNorm statistics and momentum buffers
in place, as the eager step does. The run's generator is registered with
the graph, so replay k draws what eager step k would. Python runs the
captured step once, at capture, never at a replay: the state's step count
and the kernels' launch counters (ops/cuda's LAUNCHES) are moved by the
dispatch instead, the counters by the counts the capture saw, once a
replay, so they still count kernels run on the device. A capture or
replay that fails raises: there is no eager fallback.

Under several ranks every rank dispatches chains of the same lengths, tail
included (the loaders give every rank as many batches), so the ranks'
captured collectives meet at every replay."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..ops.cuda import ee_fused, gemm_conv
from ..parallel import mesh

# every launch counter of the port's kernels
COUNTERS = (ee_fused.LAUNCHES, gemm_conv.LAUNCHES)


def chained_form(device_type: str, backend: Optional[str], world_size: int) -> str:
    """"graph" or "loop": the form of a chained dispatch on a device of
    `device_type` under a group of `world_size` ranks on `backend` (None:
    no group). One rank runs no collective, so any backend takes the
    graph; several take it only under NCCL."""
    if device_type != "cuda":
        return "loop"
    return "graph" if world_size == 1 or backend == "nccl" else "loop"


def describe_form(device_type: str, backend: Optional[str], world_size: int) -> str:
    """The driver's words for the form: "CUDA graph", "loop", or on a card
    the loop and why it is not a graph."""
    if chained_form(device_type, backend, world_size) == "graph":
        return "CUDA graph"
    if device_type == "cuda":
        return f"loop: {backend}'s collectives cannot be captured in a CUDA graph"
    return "loop"


class ChainedTrainStep:
    """step(state, xs, ys, lr) -> the last step's metrics: the K = len(xs)
    batches of the stacks xs, ys through `step_fn` (trainer.build_train_step's
    step) in order, the state updated in place and state.step advanced by
    K. In the graph form (module docstring) `capture_seconds` and
    `first_seconds` are None until the capture, then the capture's wall
    time and the eager first step's (ended by the device sync that starts
    the capture); in the loop form they stay None."""

    def __init__(self, step_fn: Callable, generator: Optional[torch.Generator] = None):
        self.step_fn, self.generator = step_fn, generator
        self.graph = None
        self.capture_seconds = self.first_seconds = None

    def __call__(self, state, xs: torch.Tensor, ys: torch.Tensor, lr: float) -> dict:
        if chained_form(xs.device.type, mesh.backend(), mesh.world_size()) == "loop":
            metrics = None
            for x, y in zip(xs, ys):
                metrics = self.step_fn(state, x, y, lr)
            return metrics
        start, metrics = 0, None
        if self.graph is None:
            t0 = time.perf_counter()
            self.lr = torch.full((), float(lr), dtype=torch.float32, device=xs.device)
            metrics = self.step_fn(state, xs[0], ys[0], self.lr)
            torch.cuda.synchronize(xs.device)
            self.first_seconds = time.perf_counter() - t0
            self._capture(state, xs[0], ys[0])
            start = 1
        elif state is not self.state:
            raise ValueError("the chained step's graph was captured on another state")
        else:
            self.lr.fill_(float(lr))
        for x, y in zip(xs[start:], ys[start:]):
            if x.shape != self.x.shape or y.shape != self.y.shape:
                raise ValueError(f"the graph was captured on a batch of "
                                 f"{tuple(self.x.shape)}, got {tuple(x.shape)}")
            self.x.copy_(x)
            self.y.copy_(y)
            self.graph.replay()
            for counter, counts in zip(COUNTERS, self.counts):
                for name, n in counts.items():
                    counter[name] += n
        state.step += len(xs) - start
        if start == len(xs):
            return metrics
        return {k: v.clone() for k, v in self.out.items()}

    def _capture(self, state, x: torch.Tensor, y: torch.Tensor) -> None:
        """Capture one train step on static copies of (x, y) and self.lr;
        undo the capture's Python side effects (state.step, the launch
        counters) and keep the counts it saw."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self.x, self.y, self.state = x.clone(), y.clone(), state
        before, step = [dict(c) for c in COUNTERS], state.step
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        # thread_local: only this thread is held to capture-safe CUDA calls
        # (the folder loader's lookahead thread may run beside the capture;
        # it makes no CUDA call, and one could not invalidate the capture)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.out = self.step_fn(state, self.x, self.y, self.lr)
        self.capture_seconds = time.perf_counter() - t0
        state.step = step
        self.counts = []
        for counter, was in zip(COUNTERS, before):
            self.counts.append({k: n - was[k] for k, n in counter.items() if n != was[k]})
            counter.update(was)
        self.graph = graph
