"""Normalization ops (port of p2p_llm_tunnel_tpu/ops/norms.py): accumulate
in fp32, cast back."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = False
) -> torch.Tensor:
    """RMSNorm. ``plus_one`` selects the gemma convention (scale = 1 + w)."""
    xf = x.to(torch.float32)
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = weight.to(torch.float32)
    scale = (1.0 + w) if plus_one else w
    return ((xf / rms) * scale).to(x.dtype)
