"""CPU milliseconds of the engine's executor thread inside its units of
device work per decode step (launch and op overhead, no fetch waits): the
window's flight records (benchmark/unit_records.py), sum of exec_cpu_ms
over sum of decode_steps."""

from benchmark import unit_records


def read(ctx):
    recs = unit_records.in_window(ctx)
    steps = sum(int(f.get("decode_steps") or 0) for f in recs or [])
    if steps == 0:
        return None
    return sum(float(f["exec_cpu_ms"]) for f in recs) / steps
