"""Percent of the engine's device time that the prefix pool's copies take:
the window's flight records (benchmark/unit_records.py), 100 * sum of
dev_pool_ms over the sum of dev_decode_ms + dev_prefill_ms + dev_pool_ms."""

from benchmark import unit_records


def read(ctx):
    recs = unit_records.in_window(ctx) or []
    pool = sum(float(f["dev_pool_ms"]) for f in recs)
    total = pool + sum(float(f["dev_decode_ms"]) + float(f["dev_prefill_ms"])
                       for f in recs)
    if total <= 0.0:
        return None
    return 100.0 * pool / total
