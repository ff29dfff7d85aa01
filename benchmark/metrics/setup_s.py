"""Seconds from the process's start to the measured window's: imports,
the kernels' build where it is not cached, the weights and batches,
the warm-up steps (and the CUDA graph's capture)."""


def read(ctx):
    return ctx.setup_s
