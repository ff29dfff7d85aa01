"""K1/K2's (csrc/ee_fused.cu) share of their roofline: the least time of
their launches in the traced span over their measured device time."""

from benchmark.metrics._shared import ee_fused_roofline_pct


def read(ctx):
    return ee_fused_roofline_pct(ctx, "train")
