"""Mean rows of a decode step: flight records in the window, sum of
decode_rows * decode_steps over sum of decode_steps."""

from benchmark import measures


def read(ctx):
    return measures.decode_rows_mean(ctx)
