"""Percent of the window in which the device's stream stood empty between
two units of engine work: the window's flight records
(benchmark/unit_records.py), 100 * sum of dev_gap_ms over the window's
milliseconds."""

from benchmark import unit_records


def read(ctx):
    recs = unit_records.in_window(ctx)
    if not recs or ctx.t1 <= ctx.t0:
        return None
    gap = sum(float(f["dev_gap_ms"]) for f in recs)
    return 100.0 * gap / ((ctx.t1 - ctx.t0) * 1e3)
