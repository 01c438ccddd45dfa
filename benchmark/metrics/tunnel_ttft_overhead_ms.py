"""Median over the window's requests of proxy.first_byte minus
engine.first_token (the port's request spans): what the tunnel adds to
time to first token."""

from benchmark import measures


def read(ctx):
    return measures.tunnel_overhead_ms(ctx)
