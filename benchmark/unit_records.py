"""The measured window's flight records that carry the port's device-timed
unit fields (dev_*_ms, exec_cpu_ms, dev_units_dropped), for their readers."""

from typing import Dict, List, Optional

from benchmark import measures


def in_window(ctx) -> Optional[List[Dict]]:
    """Records that began in the window and ended in it (t + dur_ms at most
    t1) and carry the unit fields.  The iteration still running at t1
    drains its units after the harness has started the profiler, so its
    gap holds that stall: it is left out.  None when any of them counts
    dropped units, since the fields undercount there; [] when none carries
    the fields, as in a CPU run, a run with tracing off or the parent's."""
    recs = [f for f in measures.flight_in_window(ctx)
            if "dev_gap_ms" in f
            and float(f["t"]) + float(f.get("dur_ms") or 0.0) / 1e3 <= ctx.t1]
    if any(int(f.get("dev_units_dropped") or 0) for f in recs):
        return None
    return recs
