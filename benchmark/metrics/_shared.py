"""What the per-layer readers share. Each reads the run's context (run.py's
`ctx`): the window's counts and host clock, the counts from shapes
(lib/flops.py), and in a traced run the device trace (lib/trace.py) of
`span_steps` whole steps. A reader returns None where the run has
nothing for it to read."""

from __future__ import annotations

import re

from benchmark.lib.flops import PEAK_FLOPS

# cuDNN's and CUTLASS's convolution kernels on Hopper, by name: the
# implicit-GEMM forward, data-gradient and weight-gradient kernels and the
# layout transforms cuDNN runs around them; cuDNN's BatchNorm kernels
# (cudnn::bn_fw_*, cudnn::bn_bw_*) are not convolutions
CONV_KERNELS = re.compile(
    r"conv|fprop|dgrad|wgrad|implicit_gemm|xmma|nchwToNhwc|nhwcToNchw|cutlass.*Kernel", re.I)
NOT_CONV = re.compile(r"cudnn::bn_|batch_norm|batchnorm", re.I)
EE_FWD = re.compile(r"ee_fused_fwd")
EE_BWD = re.compile(r"ee_fused_bwd")


def traced(ctx, kind: str) -> bool:
    return ctx.kind == kind and ctx.trace is not None and ctx.trace.kernels != []


def idle_pct(ctx, kind: str):
    if not traced(ctx, kind):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.span_s)


def step_mfu(ctx, kind: str):
    """The window's conv and linear operations over its host time and the
    peak of the cell's dtype."""
    if ctx.kind != kind or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops_per_image * ctx.images / ctx.window_s / PEAK_FLOPS[ctx.precision]


def conv_device_ms(ctx, kind: str):
    """Device ms a step in convolution kernels over the traced span."""
    if not traced(ctx, kind) or not ctx.span_steps:
        return None
    us = sum(d for name, _, d in ctx.trace.kernels
             if CONV_KERNELS.search(name) and not NOT_CONV.search(name))
    return us * 1e-3 / ctx.span_steps


def ee_fused_roofline_pct(ctx, kind: str):
    """K1/K2's least time (lib/flops.ee_fused_bound) over their device time
    in the traced span, launch for launch."""
    if not traced(ctx, kind):
        return None
    fwd = [d for name, _, d in ctx.trace.kernels if EE_FWD.search(name)]
    bwd = [d for name, _, d in ctx.trace.kernels if EE_BWD.search(name)]
    if not fwd and not bwd:
        return None
    bound = len(fwd) * ctx.ee_bound["fwd_s"] + len(bwd) * ctx.ee_bound["bwd_s"]
    return 100.0 * bound / ((sum(fwd) + sum(bwd)) * 1e-6)
