"""The device's side of a traced run: a ``torch.profiler`` window and what
the benchmark reads from it.

The window records the card's operations (kernels, copies, fills) and the
host's operator calls, so the two share one clock: a ``bench.sync`` range
opened at a known ``time.monotonic()`` instant maps the trace's times onto
the host's, and idle gaps can be labelled with what the engine loop was
doing.  A window can come back blind: no device event at all, or copies and
fills alone while the engine decoded (both seen on the card: the kernels'
records lost); the caller takes another.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: How many device operations and idle gaps a breakdown lists.
TOP = 10
#: Names of the device operations that are copies and fills, not kernels.
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class DeviceSummary:
    """What one profiled window showed."""

    window_s: float
    intervals: List[Tuple[float, float]]  # merged busy intervals, host s
    by_name: Dict[str, Tuple[int, float]]  # op name -> (count, seconds)
    t0: float  # window start, host monotonic s
    t1: float
    gaps: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals)

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """Launch count and device seconds of the operations whose name
        holds ``fragment``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.by_name.items():
            if fragment in name:
                n, s = n + c, s + sec
        return n, s

    def top_ops(self, k: int = TOP) -> List[List]:
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])
        return [[name[:160], sec] for name, (_, sec) in ranked[:k]]

    def top_gaps(self, phases: List[Tuple[float, str]],
                 k: int = TOP) -> List[List]:
        """The ``k`` longest idle gaps, each named by the engine loop's
        phase (``utils/flight.py``) in effect where the gap begins."""
        times = [t for t, _ in phases]
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]:
            i = bisect.bisect_right(times, a) - 1
            out.append([phases[i][1] if i >= 0 else "unknown", b - a])
        return out


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class DeviceWindow:
    """One ``torch.profiler`` window over whatever runs on the card."""

    SYNC = "bench.sync"

    def __init__(self):
        self._prof = None
        self._t_sync = 0.0
        self.t0 = self.t1 = 0.0

    @staticmethod
    def warm() -> None:
        """Start and stop one empty window, so the profiler's own start-up
        (CUPTI) is paid during set-up and not inside a measured window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.t0 = time.monotonic()
        # The range's midpoint on the trace's clock is the host instant
        # between the two stamps (the second range: the first is slower).
        for _ in range(2):
            a = time.monotonic()
            with torch.profiler.record_function(self.SYNC):
                pass
            self._t_sync = (a + time.monotonic()) / 2

    def stop(self) -> None:
        self.t1 = time.monotonic()
        self._prof.stop()

    def summary(self) -> Optional[DeviceSummary]:
        """The window's device operations on the host's clock, or None when
        it holds no kernel (a blind window)."""
        from torch.autograd import DeviceType

        events = self._prof.events()
        syncs = [e for e in events if e.name == self.SYNC]
        if not syncs:
            return None
        last = max(syncs, key=lambda e: e.time_range.start)
        offset = self._t_sync - (last.time_range.start
                                 + last.time_range.end) / 2e6
        spans, by_name = [], {}
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            a = e.time_range.start / 1e6 + offset
            b = e.time_range.end / 1e6 + offset
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            spans.append((a, b))
            n, s = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, s + (b - a))
        if all(name.startswith(NOT_KERNELS) for name in by_name):
            return None
        merged = _merge(spans)
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return DeviceSummary(window_s=self.t1 - self.t0, intervals=merged,
                             by_name=by_name, t0=self.t0, t1=self.t1,
                             gaps=gaps)
