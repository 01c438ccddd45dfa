"""Plain float32 building blocks of the architectures' reference passes.

RMSNorm, rotate-half rotary positions, grouped-query attention under a
causal mask and an optional sliding window (a query at position i sees keys
j with ``i - window < j <= i``), a SwiGLU MLP, and the products they take,
in one of two precisions:

- ``"fp32"``: every product float32 (the caller turns TF32 off);
- ``"fp8"``, the control: the same arithmetic with every operand of every
  product rounded to float8 e4m3 first (per-row scales on the activations,
  per-column scales on the weights, fp32 accumulation), the precision a
  quantised serving path would use below a configuration's bfloat16.

Nothing of the served program is imported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: Largest finite float8 e4m3 value.
FP8_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the reduction axis of the product it feeds), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ops:
    """The products of one precision: float32, or float8 operands."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a [N, K] @ w [K, M]``."""
        if self.fp8:
            a, w = fp8(a, -1), fp8(w, 0)
        return a @ w

    def scores(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """``q [H, Q, D]`` against ``k [H, T, D]``: ``[H, Q, T]``."""
        if self.fp8:
            q, k = fp8(q, -1), fp8(k, -1)
        return q @ k.transpose(1, 2)

    def mix(self, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``p [H, Q, T] @ v [H, T, D]``."""
        if self.fp8:
            p, v = fp8(p, -1), fp8(v, 1)
        return p @ v


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x [T, heads, D]`` at ``pos [T]``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(ops: Ops, q, k, v, window: Optional[int],
              block: int) -> torch.Tensor:
    """Causal attention of one sequence, within ``window`` keys where it is
    set: ``q [T, H, D]``, ``k``/``v [T, KH, D]`` -> ``[T, H * D]``, in
    blocks of queries."""
    t, h, d = q.shape
    g = h // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, T, D]
    vh = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    keys = torch.arange(t, device=q.device)
    for a in range(0, t, block):
        b = min(t, a + block)
        qb = q[a:b].transpose(0, 1)  # [H, Q, D]
        s = ops.scores(qb, kh[:, :b]) / math.sqrt(d)
        rows = torch.arange(a, b, device=q.device)[:, None]
        allowed = keys[None, :b] <= rows
        if window is not None:
            allowed = allowed & (rows - keys[None, :b] < window)
        s = s.masked_fill(~allowed[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = ops.mix(p, vh[:, :b]).transpose(0, 1)
    return out.reshape(t, h * d)


def swiglu(ops: Ops, x, gate, up, down) -> torch.Tensor:
    return ops.mm(torch.nn.functional.silu(ops.mm(x, gate.float()))
                  * ops.mm(x, up.float()), down.float())
