"""Generated tokens received by all clients in the window, per second."""

from benchmark import measures


def read(ctx):
    return measures.tokens_in_window(ctx) / ctx.seconds
