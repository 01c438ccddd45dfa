"""Seconds from the process's start to the measured window: imports,
weights, kernels, engine warm-up, stack, warm-up traffic."""


def read(ctx):
    return ctx.setup_s
