"""Percent of the device window in which no operation ran on the card."""

from benchmark import measures


def read(ctx):
    return measures.device_idle_share(ctx)
