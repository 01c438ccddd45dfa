"""Compute ops: rope, norms, plain attention, and the Hopper attention
kernels (``flash_attention``, ``decode_attention``; sources in ``csrc/``)."""

from p2p_llm_tunnel_tpu_torch.ops.rope import apply_rope, rope_table
from p2p_llm_tunnel_tpu_torch.ops.norms import rms_norm
from p2p_llm_tunnel_tpu_torch.ops.attention import (
    cached_attention,
    causal_attention,
    history_attention,
)

__all__ = [
    "apply_rope",
    "rope_table",
    "rms_norm",
    "causal_attention",
    "cached_attention",
    "history_attention",
]
