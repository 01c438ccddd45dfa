"""Percent of the HBM roofline that the fused decode layer kernel reaches
in the device window."""

from benchmark import measures


def read(ctx):
    return measures.decode_attn_roofline(ctx)
