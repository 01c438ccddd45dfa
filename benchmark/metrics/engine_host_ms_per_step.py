"""Host milliseconds of the engine loop per decode step: flight records in
the window, sum of (dur_ms - fetch_ms) over sum of decode_steps."""

from benchmark import measures


def read(ctx):
    return measures.engine_host_ms_per_step(ctx)
