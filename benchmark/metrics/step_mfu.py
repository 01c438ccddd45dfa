"""Percent of the card's bf16 peak that the window's model FLOPs (routed
experts only) fill."""

from benchmark import measures


def read(ctx):
    return measures.step_mfu(ctx)
