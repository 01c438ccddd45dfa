"""95th percentile, over the requests sent in the window, of send -> first
token byte at the client."""

from benchmark import measures


def read(ctx):
    return measures.finite(measures.nearest_rank(measures.ttfts_ms(ctx), 95))
