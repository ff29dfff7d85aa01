"""The share of the traced span in which nothing ran on the device (the
union of kernels, copies and fills against the span's host length)."""

from benchmark.metrics._shared import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
