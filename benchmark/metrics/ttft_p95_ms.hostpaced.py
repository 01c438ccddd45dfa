"""The 95th percentile of time to first token (send to first token byte at
the client, over the requests sent in the window) in a cell whose device
idles most of the time: it follows the engine loop's pace and moves with
out_tok_s."""

from benchmark import measures


def read(ctx):
    return measures.finite(measures.nearest_rank(measures.ttfts_ms(ctx), 95))
