"""What the benchmark records beside the program while it runs.

Two light wrappers, installed on the running engine by the benchmark and
never by the program:

- every decode burst's rows: the engine's decode program is called with
  the rows the host patched (``ov_mask``/``ov_pos``), and every other row
  carries on from where the previous burst left it, ``steps`` positions
  further; rows parked at ``max_seq`` are idle.  So the position of every
  row of every step is known on the host without reading the device;
- the engine loop's phase (``utils/flight.py``'s ``set_phase``), stamped
  with ``time.monotonic()``, while a device window is open.

And what the host gave the stack over the window (``HostLoad``): its
process's CPU seconds, thread by thread, every process's CPU on the
machine and the interpreter's garbage-collection pauses.
"""

from __future__ import annotations

import gc
import os
import resource
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class BurstLog:
    """Each decode burst: ``(host instant, [(first position, steps)] of its
    live rows)``."""

    def __init__(self, engine):
        self.bursts: List[Tuple[float, List[Tuple[int, int]]]] = []
        self._engine = engine
        self._max_seq = engine.ecfg.max_seq
        self._pos = None
        self._steps = 0
        self._inner = engine._decode_fn
        engine._decode_fn = self._decode

    def _decode(self, ov_mask, ov_tok, ov_pos, samp, kv_view, steps):
        mask = np.asarray(ov_mask, bool)
        pos = np.asarray(ov_pos, np.int64)
        if self._pos is not None:
            pos = np.where(mask, pos, self._pos + self._steps)
        else:
            pos = np.where(mask, pos, 0)
        self._pos, self._steps = pos, int(steps)
        rows = [(int(p), int(steps)) for p in pos if p < self._max_seq]
        self.bursts.append((time.monotonic(), rows))
        return self._inner(ov_mask, ov_tok, ov_pos, samp, kv_view, steps)

    def release(self) -> None:
        """Let go of the engine (its device state can then be freed)."""
        self._engine = self._inner = None

    def between(self, t0: float, t1: float) -> List[List[Tuple[int, int]]]:
        return [rows for t, rows in self.bursts if t0 <= t < t1]


class PhaseLog:
    """The engine loop's phases with their start instants."""

    def __init__(self, flight):
        self.phases: List[Tuple[float, str]] = []
        self._flight = flight
        self._inner = flight.set_phase
        flight.set_phase = self._set

    def _set(self, phase: str) -> None:
        self.phases.append((time.monotonic(), phase))
        self._inner(phase)

    def close(self) -> None:
        self._flight.set_phase = self._inner


def _cpu_ticks(stat_dir: str) -> Dict[str, Tuple[str, int]]:
    """``{id: (name, utime + stime ticks)}`` of every entry of a /proc
    directory of processes or of one process's threads."""
    out = {}
    try:
        ids = [d for d in os.listdir(stat_dir) if d.isdigit()]
    except OSError:
        return out
    for d in ids:
        try:
            with open(f"{stat_dir}/{d}/stat") as f:
                raw = f.read()
        except OSError:
            continue
        name = raw[raw.index("(") + 1:raw.rindex(")")]
        rest = raw[raw.rindex(")") + 2:].split()
        out[d] = (name, int(rest[11]) + int(rest[12]))  # fields 14, 15
    return out


class HostLoad:
    """The host's share of a window: ``start()`` and ``stop()`` bracket it.

    Reads the stack process's CPU seconds as a whole and thread by thread
    (the interpreter lock lets one thread run at a time, so a host-paced
    stack reads one core), every process's CPU on the machine (the client
    among them) and the interpreter's garbage-collection pauses."""

    TICK = os.sysconf("SC_CLK_TCK")

    def __init__(self):
        self._gc_t: Optional[float] = None
        self.gc_pauses: List[Tuple[int, float]] = []  # (generation, seconds)
        self._open = False
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: Dict) -> None:
        if not self._open:
            return
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_pauses.append((info["generation"],
                                   time.perf_counter() - self._gc_t))
            self._gc_t = None

    @staticmethod
    def _now():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (time.monotonic(), ru.ru_utime + ru.ru_stime,
                _cpu_ticks("/proc/self/task"), _cpu_ticks("/proc"))

    def start(self) -> None:
        self._t0 = self._now()
        self._open = True

    def _top(self, a, b, dt, n=4):
        rows = [(b[k][0], (b[k][1] - a[k][1]) / self.TICK / dt)
                for k in b if k in a]
        rows.sort(key=lambda r: -r[1])
        return [[name, round(share, 3)] for name, share in rows[:n]]

    def stop(self) -> Dict:
        self._open = False
        gc.callbacks.remove(self._gc)
        t1, cpu1, th1, pr1 = self._now()
        t0, cpu0, th0, pr0 = self._t0
        dt = t1 - t0
        names = {str(t.native_id): t.name for t in threading.enumerate()}
        th1 = {k: (names.get(k, v[0]), v[1]) for k, v in th1.items()}
        return {"stack_cpu_share": (cpu1 - cpu0) / dt,
                "stack_threads": self._top(th0, th1, dt),
                "processes": self._top(pr0, pr1, dt),
                "gc_pauses": len(self.gc_pauses),
                "gc_pause_s": sum(s for _, s in self.gc_pauses)}
