"""Device milliseconds of the engine's decode units per decode step: the
window's flight records (the port's CUDA-event units, written in traced
runs on the card; benchmark/unit_records.py), sum of dev_decode_ms over sum
of decode_steps.  A unit's device time runs from its start event to its
end event, so it holds the idle time inside a burst (launch gaps, host
syncs) as well as the model's kernels: in a host-paced cell it moves with
launch overhead as much as with model compute."""

from benchmark import unit_records


def read(ctx):
    recs = unit_records.in_window(ctx)
    steps = sum(int(f.get("decode_steps") or 0) for f in recs or [])
    if steps == 0:
        return None
    return sum(float(f["dev_decode_ms"]) for f in recs) / steps
