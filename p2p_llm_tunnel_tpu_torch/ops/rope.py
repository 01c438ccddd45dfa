"""Rotary position embeddings (port of p2p_llm_tunnel_tpu/ops/rope.py).

The expression graph is the reference's, op for op: fp32 frequencies and
angles, rotate-half split, and the same multiply/subtract order — an
algebraically equal rewrite flips low bits and, through greedy argmax,
whole tokens.
"""

from __future__ import annotations

import torch


def rope_table(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for given positions; shapes [..., head_dim/2]."""
    exponent = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., D/2]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate q or k. x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    head_dim = x.shape[-1]
    sin, cos = rope_table(positions, head_dim, theta)  # [..., seq, D/2]
    sin = sin[..., None, :]  # broadcast over heads: [..., seq, 1, D/2]
    cos = cos[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)  # rotate-half convention
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    out = torch.cat([rx1, rx2], dim=-1)
    return out.to(x.dtype)
