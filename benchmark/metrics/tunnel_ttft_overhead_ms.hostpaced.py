"""Median over the window's requests of proxy.first_byte minus
engine.first_token, in a cell whose device idles most of the time: the
tunnel's work shares the engine loop's host, so it moves out_tok_s."""

from benchmark import measures


def read(ctx):
    return measures.tunnel_overhead_ms(ctx)
