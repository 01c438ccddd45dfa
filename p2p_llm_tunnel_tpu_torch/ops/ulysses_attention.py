"""Ulysses (all-to-all) sequence parallelism for causal attention (port of
p2p_llm_tunnel_tpu/ops/ulysses_attention.py).

The second of the two sequence-parallel strategies (ring attention is the
first, ``ops/ring_attention``): instead of passing K/V blocks around the
ring, each rank swaps its SEQUENCE block for a HEAD block with one tiled
all-to-all (``parallel/collectives.all_to_all``), runs ordinary
full-sequence causal attention over its head slice — kernel 1
(``ops/flash_attention.flash_causal_attention``) on the card, its plain
version on the CPU — and swaps back.  Pad masks and sliding windows work
unchanged, because every rank sees the whole sequence.  Needs each tp
shard's query and kv head counts divisible by sp (GQA kv heads are
swapped too).
"""

from __future__ import annotations

from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
from p2p_llm_tunnel_tpu_torch.parallel.collectives import all_to_all


def check_heads(h: int, kh: int, sp: int, tp: int = 1) -> None:
    """The reference's ``make_ulysses_attention`` check: ``H`` and ``K``
    (the model's, before tp) must divide over tp, and each shard's over sp."""
    if (h // tp) % sp or (kh // tp) % sp or h % tp or kh % tp:
        raise ValueError(
            f"ulysses needs per-tp-shard head counts divisible by "
            f"sp={sp}; got H={h}, K={kh}, tp={tp} (use ring attention)"
        )


def ulysses_attention(
    q: torch.Tensor,  # [B, T/sp, H', D] this rank's sequence block
    k: torch.Tensor,  # [B, T/sp, K', D]
    v: torch.Tensor,  # [B, T/sp, K', D]
    valid: torch.Tensor,  # [B, T] the whole sequence's pad mask
    *,
    group,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One rank's program over the sp ``group``: ``H'``/``K'`` are this tp
    shard's heads, each divisible by sp (the caller runs ``check_heads``).
    Returns this rank's sequence block of the output, ``[B, T/sp, H', D]``."""
    # sequence block -> head block: split heads (axis 2), gather sequence.
    q_h, k_h, v_h = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    out = flash_causal_attention(q_h, k_h, v_h, valid.contiguous(), scale=scale,
                                 softcap=softcap, window=window)  # [B,T,H'/sp,D]
    # head block -> sequence block for the residual stream.
    return all_to_all(out, 1, 2, group)
