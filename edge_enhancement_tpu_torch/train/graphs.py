"""K train steps a dispatch, the port's counterpart of the JAX package's
build_chained_train_step (edge_enhancement_tpu/train/trainer.py), which
runs the K steps as one lax.scan over a stack of K batches. Here the same K
steps run with one host synchronisation: on a CUDA device as a replayed
CUDA graph of one train step, on the CPU as a loop of the step.

The graph form. The run's first step runs eagerly: a real step, which also
builds every lazy constant (the kernels' libraries and operators, the
pixel scale, cuBLAS's handle). Then one train step is captured on static
buffers: one batch (x, y) and the learning rate, a 0-dim tensor filled
before each dispatch, so a replay follows the epoch's rate without a new
capture. Every later step is a device-to-device copy into the buffers and
one replay; a tail chain is fewer replays, and a run captures once. The
graph updates the model's parameters, BatchNorm statistics and momentum
buffers in place, as the eager step does. The run's generator is
registered with the graph, so replay k draws what eager step k would.
Python runs the captured step once, at capture, never at a replay: the
state's step count and the kernels' launch counters (ops/cuda's LAUNCHES)
are moved by the dispatch instead, the counters by the counts the capture
saw, once a replay, so they still count kernels run on the device. A
capture or replay that fails raises: there is no eager fallback."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..ops.cuda import ee_fused, gemm_conv
from ..parallel import mesh

# every launch counter of the port's kernels
COUNTERS = (ee_fused.LAUNCHES, gemm_conv.LAUNCHES)


def check_chained(device_type: str, world_size: int) -> None:
    """Raise where the chained step cannot run: on CUDA under a process
    group of more than one rank. The train step's gloo all-reduces
    (parallel/mesh.py) cannot be captured in a CUDA graph, and NCCL's
    capture needs a card a rank, which no run has had. On the CPU the loop
    form runs under any group."""
    if device_type == "cuda" and world_size > 1:
        raise NotImplementedError(
            f"steps_per_dispatch > 1 on CUDA under {world_size} ranks: gloo's "
            "collectives cannot be captured in a CUDA graph, and NCCL capture is "
            "not ported")


class ChainedTrainStep:
    """step(state, xs, ys, lr) -> the last step's metrics: the K = len(xs)
    batches of the stacks xs, ys through `step_fn` (trainer.build_train_step's
    step) in order, the state updated in place and state.step advanced by
    K. On CUDA tensors the graph form (module docstring); until the
    capture `capture_seconds` and `first_seconds` are None, then the
    capture's wall time and the eager first step's (ended by the device
    sync that starts the capture)."""

    def __init__(self, step_fn: Callable, generator: Optional[torch.Generator] = None):
        self.step_fn, self.generator = step_fn, generator
        self.graph = None
        self.capture_seconds = self.first_seconds = None

    def __call__(self, state, xs: torch.Tensor, ys: torch.Tensor, lr: float) -> dict:
        if xs.device.type != "cuda":
            metrics = None
            for x, y in zip(xs, ys):
                metrics = self.step_fn(state, x, y, lr)
            return metrics
        check_chained("cuda", mesh.world_size())
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
