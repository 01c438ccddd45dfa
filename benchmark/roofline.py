"""Peaks of the card and the arithmetic every architecture's counts share.

The yardstick of the benchmark's shares of a roofline or of a peak: the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W).  The operation and byte counts of a served model live with its
architecture (``benchmark/arch/<name>.py``) and are computed from its
shape alone.  The arithmetic of a kernel's bound follows ``chip_smoke.py``'s
phase 2 (each input byte read once, each output byte written once; the
bound is the larger of bytes over the memory rate and operations over the
compute rate).
"""

from __future__ import annotations

#: One H100 SXM: dense bf16 tensor rate and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

BF16 = 2


def context_sum(start: int, stop: int, window) -> int:
    """Sum over positions ``p`` in ``[start, stop)`` of the keys ``p`` sees:
    ``p + 1``, or the window where it is shorter."""
    a, b = start + 1, stop  # contexts a..b
    if b < a:
        return 0
    w = b if window is None else min(b, window)
    total = 0
    if a <= w:
        total += (a + w) * (w - a + 1) // 2
    if b > w:
        total += (b - max(w, a - 1)) * w
    return total
