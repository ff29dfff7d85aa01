"""The device trace of a traced run: torch.profiler (CUPTI) around a span
of whole steps after the measured window, its Chrome trace written under
TMPDIR, read back and deleted. From it: every device activity (kernels,
copies, fills) with its name, start and length; the host's operators; the
busy seconds (the union of the device activities) against the span's
length; the device operations that took most time; the longest idle gaps,
named by the innermost host operator running when each began."""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160      # names in the breakdown are cut to this many characters


@dataclasses.dataclass
class Trace:
    span_s: float          # the traced span, host clock, from its start to its end sync
    kernels: list          # (name, start_us, dur_us) of every device activity
    host_ops: list         # (name, start_us, dur_us) of the host's operators

    @property
    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device."""
        busy, end = 0.0, None
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            e = s + d
            if end is None or s > end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for name, _, d in self.kernels:
            by[name[:NAME_CHARS]] += d * 1e-6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle gaps between device activities, summed by the innermost
        host operator running when each began, the largest first."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        ops = sorted(self.host_ops, key=lambda o: o[1])
        by, end = collections.Counter(), None
        for _, s, d in ks:
            if end is not None and s > end:
                by[_host_at(ops, end)[:NAME_CHARS]] += (s - end) * 1e-6
            end = s + d if end is None else max(end, s + d)
        return [[n, s] for n, s in by.most_common(top)]


def _host_at(ops: list, t: float) -> str:
    """The innermost (shortest) host operator that spans time t."""
    best = None
    for name, s, d in ops:
        if s > t:
            break
        if s + d >= t and (best is None or d < best[1]):
            best = (name, d)
    return best[0] if best else "host: no operator"


def profile(run_span, device) -> Trace:
    """Trace `run_span()` (whole steps, ending in their sync)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_span()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        span_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        row = (str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
        if cat in DEVICE_CATS:
            kernels.append(row)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "python_function"):
            host.append(row)
    return Trace(span_s, kernels, host)
