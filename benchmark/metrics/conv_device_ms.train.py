"""Device milliseconds a step in convolution kernels (by name,
metrics/_shared.CONV_KERNELS) over the traced span."""

from benchmark.metrics._shared import conv_device_ms


def read(ctx):
    return conv_device_ms(ctx, "train")
