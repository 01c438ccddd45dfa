"""Percent of the prompt tokens sent in the window that the prefix pool
served."""

from benchmark import measures


def read(ctx):
    return measures.prefix_hit_share(ctx)
