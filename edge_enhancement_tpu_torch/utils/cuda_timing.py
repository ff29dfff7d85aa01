"""Timing on a CUDA device, for chip_smoke.py and the benchmark tools.

`device_ms` is a kernel's device time per call: calls captured in one CUDA
graph and replayed, so no host work sits between the launches. `median_ms`
is what one eager call costs a caller, host launch work included. Both need
a CUDA device.
"""

from __future__ import annotations

import torch


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timed eager calls after `warmup` untimed
    ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: one warm-up call on a side stream, then `calls`
    calls captured in one CUDA graph; median of `reps` replays (after one
    untimed replay). `fn` runs 1 + `calls` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    times = sorted(times[1:])
    return times[len(times) // 2]
