"""Percent of the model's device time that its MoE blocks take: the
window's flight records (benchmark/unit_records.py), 100 * sum of
dev_moe_ms over the sum of dev_decode_ms + dev_prefill_ms (the units the
blocks run in)."""

from benchmark import unit_records


def read(ctx):
    recs = unit_records.in_window(ctx) or []
    moe = [float(f["dev_moe_ms"]) for f in recs if "dev_moe_ms" in f]
    model = sum(float(f["dev_decode_ms"]) + float(f["dev_prefill_ms"])
                for f in recs)
    if not moe or model <= 0.0:
        return None
    return 100.0 * sum(moe) / model
