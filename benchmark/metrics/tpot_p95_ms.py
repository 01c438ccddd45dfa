"""95th percentile, over the requests completed in the window, of (last -
first token arrival) / (tokens - 1) at the client."""

from benchmark import measures


def read(ctx):
    return measures.finite(measures.nearest_rank(measures.tpots_ms(ctx), 95))
