"""Images trained (their attack included) over the window's host time."""


def read(ctx):
    return ctx.images / ctx.window_s if ctx.kind == "train" else None
