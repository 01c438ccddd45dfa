"""The 95th percentile of time per output token (over the requests
completed in the window) in a cell whose device idles most of the time:
it follows the engine loop's pace and moves with out_tok_s."""

from benchmark import measures


def read(ctx):
    return measures.finite(measures.nearest_rank(measures.tpots_ms(ctx), 95))
