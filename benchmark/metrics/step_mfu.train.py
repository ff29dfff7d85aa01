"""The whole step's share of the chip's peak: the convolutions' and the
head's operations that the window's steps need (lib/flops.py), over the
window's host time and the peak FLOP/s of the cell's dtype."""

from benchmark.metrics._shared import step_mfu


def read(ctx):
    return step_mfu(ctx, "train")
