"""Percent of the prompt tokens sent in the window that the prefix pool
served, in a cell whose device idles most of the time: there time to first
token follows the engine loop's pace, so the share moves out_tok_s."""

from benchmark import measures


def read(ctx):
    return measures.prefix_hit_share(ctx)
