"""Plain attention (port of p2p_llm_tunnel_tpu/ops/attention.py).

Batched GQA for prefill (causal), prefill-with-history and slot decode
(cached), in plain torch: fp32 scores and softmax, the reference's
``_NEG_INF`` masking, optional gemma-2 softcap and sliding window.  These
are the numerics oracle and the PLAIN VERSIONS of the two Hopper kernels
(``ops/flash_attention.py``, ``ops/decode_attention.py``): their wrappers
run these on CPU tensors, and ``chip_smoke.py`` holds the kernels against
them on the card.

bf16 inputs are widened to fp32 before each einsum — the exact products
plus fp32 accumulation of the reference's ``preferred_element_type``.

Shapes (B=batch/slots, T=query len, S=kv len, H=q heads, K=kv heads, G=H/K,
D=head dim): activations [B, T, H, D]; kv cache [B, S, K, D].
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B,T,K,G,D] × k [B,S,K,D] → scores [B,K,G,T,S] in fp32."""
    return torch.einsum(
        "btkgd,bskd->bkgts", q.to(torch.float32), k.to(torch.float32)
    ) * scale


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B,K,G,T,S] × v [B,S,K,D] → out [B,T,K,G,D]."""
    return torch.einsum("bkgts,bskd->btkgd", probs, v.to(torch.float32))


def _softmax_rows(scores: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Self-attention over one padded prompt batch (prefill).

    q [B,T,H,D], k/v [B,T,K,D], valid [B,T] bool marks real (non-pad) tokens.
    """
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5

    q5 = q.reshape(b, t, kh, g, d)
    scores = _softcap(_gqa_scores(q5, k, scale), softcap)  # [B,K,G,T,S]

    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = j <= i  # causal
    if window is not None:
        mask = mask & ((i - j) < window)
    mask = mask[None, None, None, :, :] & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    out = _gqa_out(_softmax_rows(scores), v)
    return out.reshape(b, t, h, d).to(q.dtype)


def history_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    starts: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Chunk attention for prefill-with-history: row ``r``'s query ``t``
    sits at global position ``starts[r] + t`` and attends cache index
    ``j <= starts[r] + t`` (within the window when set).

    q [B,T,H,D]; k/v_cache [B,S,K,D]; starts [B] int.
    """
    b, t, h, d = q.shape
    kh = k_cache.shape[2]
    g_heads = h // kh
    if scale is None:
        scale = d**-0.5

    q5 = q.reshape(b, t, kh, g_heads, d)
    scores = _softcap(_gqa_scores(q5, k_cache, scale), softcap)

    s = k_cache.shape[1]
    g = starts[:, None] + torch.arange(t, device=q.device)[None, :]  # [B,T]
    j = torch.arange(s, device=q.device)[None, None, :]  # [1,1,S]
    mask = j <= g[:, :, None]  # [B,T,S]
    if window is not None:
        mask = mask & ((g[:, :, None] - j) < window)
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    out = _gqa_out(_softmax_rows(scores), v_cache)
    return out.reshape(b, t, h, d).to(q.dtype)


def cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token-per-slot decode attention against the KV cache.

    q [B,1,H,D]; k/v_cache [B,S,K,D] (any slot stride); q_positions [B] =
    the query token's position.  Cache index j is attendable when
    j <= q_position (and within the sliding window when set).
    """
    b, t, h, d = q.shape
    assert t == 1, "decode step processes exactly one token per slot"
    kh = k_cache.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5

    q5 = q.reshape(b, 1, kh, g, d)
    scores = _softcap(_gqa_scores(q5, k_cache, scale), softcap)  # [B,K,G,1,S]

    s = k_cache.shape[1]
    j = torch.arange(s, device=q.device)[None, :]  # [1,S]
    pos = q_positions.to(torch.int64)[:, None]  # [B,1]
    mask = j <= pos
    if window is not None:
        mask = mask & ((pos - j) < window)
    scores = torch.where(mask[:, None, None, None, :], scores, _NEG_INF)
    out = _gqa_out(_softmax_rows(scores), v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)
