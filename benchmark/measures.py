"""What a run hands its metric readers, and the arithmetic they share.

Each metric is a reader of its own, ``benchmark/metrics/<name>.py``, with
one function ``read(ctx) -> float | None``; the harness finds it by the
metric's name in ``BENCHMARK.json``.  A reader that finds nothing to read
returns None and the metric is left out of the run's line.
"""

from __future__ import annotations

import importlib.util
import math
import statistics
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import roofline
from benchmark.client import ok

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclass
class Context:
    """One run's records, on the host's ``time.monotonic()`` clock."""

    shape: object  # the architecture's Shape
    arch: ModuleType  # the configuration's benchmark/arch/<name>.py
    seconds: float
    t0: float  # the measured window
    t1: float
    setup_s: float
    requests: List[Dict]  # client.py's records
    flight: List[Dict] = field(default_factory=list)  # utils/flight records
    spans: List = field(default_factory=list)  # utils/tracing SpanRecords
    counters: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    device: Optional[object] = None  # devtrace.DeviceSummary
    bursts: Optional[object] = None  # probes.BurstLog

    def delta(self, name: str) -> Optional[float]:
        if name not in self.counters:
            return None
        a, b = self.counters[name]
        return b - a

    def sent_in_window(self) -> List[Dict]:
        return [r for r in self.requests if self.t0 <= r["send"] < self.t1]


def load(name: str) -> Callable:
    """The ``read`` function of metric ``name``."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nearest_rank(values: List[float], p: float) -> Optional[float]:
    """The ``p``-th percentile by nearest rank: the smallest value with at
    least ``p`` percent of the values at or below it."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]


def ttfts_ms(ctx: Context) -> List[float]:
    """Send -> first token, for every request sent in the window; one that
    never got its first token, or failed, counts as infinitely late."""
    out = []
    for r in ctx.sent_in_window():
        if r["times"] and ok(r):
            out.append((r["times"][0] - r["send"]) * 1e3)
        else:
            out.append(math.inf)
    return out


def tpots_ms(ctx: Context) -> List[float]:
    """(last - first token arrival) / (tokens - 1) of every request that
    completed in the window; a failed one counts as infinitely slow."""
    out = []
    for r in ctx.requests:
        end = r.get("end", math.inf)
        if not ctx.t0 <= end < ctx.t1:
            continue
        if not ok(r):
            out.append(math.inf)
        elif len(r["times"]) > 1:
            out.append((r["times"][-1] - r["times"][0]) * 1e3
                       / (len(r["times"]) - 1))
    return out


def finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None


def tokens_in_window(ctx: Context) -> int:
    return sum(1 for r in ctx.requests for t in r["times"]
               if ctx.t0 <= t < ctx.t1)


def rate_series(recs: List[Dict], start: float, stop: float,
                step: float) -> List[float]:
    """Tokens a second at the clients in ``step``-second slices of
    ``[start, stop)``: whether a window saw a steady state."""
    counts = [0] * int((stop - start) // step)
    for r in recs:
        for t in r["times"]:
            i = int((t - start) // step)
            if 0 <= i < len(counts):
                counts[i] += 1
    return [n / step for n in counts]


def flight_in_window(ctx: Context) -> List[Dict]:
    return [f for f in ctx.flight if ctx.t0 <= float(f.get("t", 0.0)) < ctx.t1]


def engine_host_ms_per_step(ctx: Context) -> Optional[float]:
    """Host milliseconds of the engine loop per decode step: its iterations
    in the window, less the time each waited on the device's results."""
    recs = flight_in_window(ctx)
    steps = sum(int(f.get("decode_steps") or 0) for f in recs)
    if steps == 0:
        return None
    host = sum(float(f.get("dur_ms") or 0.0) - float(f.get("fetch_ms") or 0.0)
               for f in recs)
    return host / steps


def decode_rows_mean(ctx: Context) -> Optional[float]:
    """Mean live rows of the window's decode steps."""
    recs = flight_in_window(ctx)
    steps = sum(int(f.get("decode_steps") or 0) for f in recs)
    if steps == 0:
        return None
    return sum(int(f.get("decode_rows") or 0) * int(f.get("decode_steps") or 0)
               for f in recs) / steps


def tunnel_overhead_ms(ctx: Context) -> Optional[float]:
    """Median over the window's requests of proxy.first_byte minus
    engine.first_token (``utils/tracing.py`` spans of one trace id)."""
    first_byte, first_token = {}, {}
    for s in ctx.spans:
        if s.name == "proxy.first_byte":
            first_byte[s.trace_id] = s.ts
        elif s.name == "engine.first_token":
            first_token[s.trace_id] = s.ts
    gaps = [(t - first_token[tid]) * 1e3 for tid, t in first_byte.items()
            if tid in first_token and ctx.t0 <= t < ctx.t1]
    return statistics.median(gaps) if gaps else None


def prefix_hit_share(ctx: Context) -> Optional[float]:
    """Percent of the prompt tokens sent in the window that the prefix pool
    served (the engine's ``engine_prefix_hit_tokens_total`` over it)."""
    hits = ctx.delta("engine_prefix_hit_tokens_total")
    sent = sum(len(r["prompt"]) for r in ctx.sent_in_window())
    if hits is None or sent == 0:
        return None
    return 100.0 * hits / sent


def window_flops(ctx: Context) -> float:
    """The model's FLOPs of the window, counted from what the clients
    received: each served token after a request's first at its position
    (one decode step), and for each request whose first token arrived in
    the window its prompt less its share of the window's prefix-pool hits
    (hits spread over those prompts in proportion to their lengths)."""
    shape, counts = ctx.shape, ctx.arch
    total = 0.0
    prefilled = []
    for r in ctx.requests:
        p = len(r["prompt"])
        for k, t in enumerate(r["times"]):
            if not ctx.t0 <= t < ctx.t1:
                continue
            if k == 0:
                prefilled.append(p)
            else:
                total += counts.decode_flops(shape, p + k - 1)
    hits = ctx.delta("engine_prefix_hit_tokens_total") or 0.0
    share = min(1.0, hits / sum(prefilled)) if prefilled else 0.0
    for p in prefilled:
        total += counts.prefill_flops(shape, int(round(p * share)), p)
    return total


def step_mfu(ctx: Context) -> Optional[float]:
    if not ctx.requests:
        return None
    return 100.0 * window_flops(ctx) / (ctx.seconds * roofline.PEAK_BF16_FLOPS)


def decode_attn_roofline(ctx: Context) -> Optional[float]:
    """Percent of the HBM roofline that the fused decode layer (kernel 4)
    reached in the device window: the mean bytes a launch needs (every
    decode burst dispatched in the window, one launch per layer and step)
    over the peak rate, against the mean device time of a launch."""
    d = ctx.device
    if d is None or ctx.bursts is None:
        return None
    n, secs = d.kernel("fused_decode_layer_kernel")
    bursts = ctx.bursts.between(d.t0, d.t1)
    steps = sum(rows[0][1] for rows in bursts if rows)
    if n == 0 or steps == 0:
        return None
    nbytes = sum(ctx.arch.burst_bytes(ctx.shape, rows) for rows in bursts)
    return 100.0 * (nbytes / steps / roofline.PEAK_HBM_BYTES_S) / (secs / n)


def device_idle_share(ctx: Context) -> Optional[float]:
    d = ctx.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
