"""Token sampling: greedy, temperature, top-k, top-p, penalties, logit
bias and logprobs (port of p2p_llm_tunnel_tpu/engine/sampling.py).

One sampler over the whole slot batch per decode step; sampling controls
are per-row arrays, so mixed requests batch together.

Idiom differences from the JAX reference, both deliberate:

- ``SamplingParams`` holds HOST numpy arrays.  Where the reference hides a
  [B, V] pass behind a ``lax.cond`` on ``any(...)``, this port branches in
  Python on the host array — no device sync — and moves a control to the
  logits' device only on the path that reads it (an all-greedy batch
  moves nothing).
- Seeded draws cannot reproduce ``jax.random``.  They keep the reference's
  contract (``sampling.py:177-189``): a row's draw is a pure function of
  (seed, position) — identical whatever the batch holds.  Each row draws
  Gumbel noise from a counter-based hash of (seed, position, token id) and
  takes ``argmax(logits + noise)``, which samples the softmax exactly.
  Greedy rows are exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

#: Static top-alternatives width for logprob reporting (the reference's
#: TOP_LOGPROBS_CAP: the OpenAI chat spec's top_logprobs upper bound).
TOP_LOGPROBS_CAP = 20

_MASK32 = 0xFFFFFFFF


class SamplingParams(NamedTuple):
    """Per-row sampling controls, all [B] host numpy arrays."""

    temperature: np.ndarray  # float32, 0 → greedy
    top_k: np.ndarray  # int32, 0 → disabled
    top_p: np.ndarray  # float32, 1.0 → disabled
    freq_pen: np.ndarray  # float32, OpenAI frequency_penalty
    pres_pen: np.ndarray  # float32, OpenAI presence_penalty
    logprobs: np.ndarray  # int32, requested top_logprobs count
    # Per-request sampling seed (uint32); None → unseeded draws from the
    # caller's torch.Generator.
    seed: Optional[np.ndarray] = None
    # Rows with a live OpenAI logit_bias (bool); None → feature unused.
    bias_on: Optional[np.ndarray] = None


def make_params(batch, temperature=0.0, top_k=0, top_p=1.0,
                freq_pen=0.0, pres_pen=0.0, logprobs=0,
                seed=0) -> SamplingParams:
    return SamplingParams(
        temperature=np.full((batch,), temperature, np.float32),
        top_k=np.full((batch,), top_k, np.int32),
        top_p=np.full((batch,), top_p, np.float32),
        freq_pen=np.full((batch,), freq_pen, np.float32),
        pres_pen=np.full((batch,), pres_pen, np.float32),
        logprobs=np.full((batch,), logprobs, np.int32),
        seed=np.full((batch,), seed, np.uint32),
    )


def lp_width(vocab_size: int) -> int:
    """Static top-alternatives width: the CAP, clamped to the vocabulary."""
    return min(TOP_LOGPROBS_CAP, vocab_size)


def logprob_data(logits: torch.Tensor, sampled: torch.Tensor):
    """(chosen_lp [B], top_ids [B,W] int32, top_lps [B,W] f32) of the RAW
    model distribution (before penalties/temperature/truncation)."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, sampled[:, None].long())[:, 0] - lse
    top_vals, top_ids = torch.topk(logits, lp_width(logits.shape[-1]), dim=-1)
    return chosen, top_ids.to(torch.int32), top_vals - lse[:, None]


def empty_logprob_data(batch: int, vocab_size: int, device=None):
    """Zero-filled logprob tuple, shape-matched to logprob_data."""
    w = lp_width(vocab_size)
    return (
        torch.zeros((batch,), dtype=torch.float32, device=device),
        torch.zeros((batch, w), dtype=torch.int32, device=device),
        torch.zeros((batch, w), dtype=torch.float32, device=device),
    )


def _to(arr: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=dtype).to(like.device, non_blocking=True)


def sample(
    logits: torch.Tensor,  # [B, V] fp32
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
    counts: Optional[torch.Tensor] = None,  # [B, V] generated-token counts
    pos: Optional[torch.Tensor] = None,  # [B] index of the token being sampled
    bias: Optional[torch.Tensor] = None,  # [B, V] per-row logit_bias
) -> torch.Tensor:
    """Sample one token per row -> [B] int32.  Same order of modifiers as
    the reference: logit bias, then frequency/presence penalties over the
    generated-token ``counts`` (both shift greedy decoding too), then
    temperature, top-k and top-p for the stochastic rows."""
    if bias is not None and params.bias_on is not None and params.bias_on.any():
        logits = logits + bias
    if counts is not None and (
        (params.freq_pen != 0.0).any() or (params.pres_pen != 0.0).any()
    ):
        c = counts.to(torch.float32)
        logits = logits - (
            _to(params.freq_pen, logits)[:, None] * c
            + _to(params.pres_pen, logits)[:, None] * (c > 0)
        )
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (params.temperature > 0.0).any():
        return greedy
    return _sample_stochastic(logits, params, generator, greedy, pos)


def _sample_stochastic(
    logits: torch.Tensor,
    params: SamplingParams,
    generator: Optional[torch.Generator],
    greedy: torch.Tensor,
    pos: Optional[torch.Tensor],
) -> torch.Tensor:
    b, v = logits.shape
    temp = _to(np.maximum(params.temperature, 1e-6), logits)[:, None]
    scaled = logits / temp

    # Top-k: mask everything below the k-th largest. k==0 disables.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = _to(np.clip(params.top_k, 0, v), logits, torch.int64)
    kth_idx = (k - 1).clamp(0, v - 1)
    kth_val = torch.gather(sorted_desc, -1, kth_idx[:, None])
    scaled = torch.where(
        (k[:, None] > 0) & (scaled < kth_val), float("-inf"), scaled
    )

    # Top-p (nucleus): keep the smallest prefix of the sorted distribution
    # whose cumulative probability exceeds p. p>=1 disables.
    sorted_desc2 = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_desc2, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    top_p = _to(params.top_p, logits)[:, None]
    keep_sorted = (cum - probs_sorted) < top_p
    cutoff = torch.where(keep_sorted, sorted_desc2, float("inf")).amin(
        dim=-1, keepdim=True
    )  # smallest kept logit
    scaled = torch.where((top_p < 1.0) & (scaled < cutoff), float("-inf"), scaled)

    if pos is not None and params.seed is not None:
        noise = _seeded_gumbel(
            _to(params.seed.astype(np.int64), logits, torch.int64),
            pos.to(torch.int64), v,
        )
    else:
        u = torch.rand(
            (b, v), generator=generator, device=logits.device
        ).clamp_(1e-12, 1.0 - 1e-7)
        noise = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    temp_pos = _to(params.temperature, logits) > 0.0
    return torch.where(temp_pos, sampled, greedy)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32 in int64, split in 16-bit
    halves so no intermediate product leaves the int64 range."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (xorshift-multiply rounds) on int64 lanes."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seeded_gumbel(seed: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] standard Gumbel noise, entry (b, j) a pure function of
    (seed[b], pos[b], j) — independent of batch composition and order."""
    row = _hash32(_hash32(seed ^ 0x5EED) ^ _hash32(pos + 0x9E3779B9))  # [B]
    ids = torch.arange(vocab, device=seed.device, dtype=torch.int64)
    bits = _hash32(row[:, None] ^ _mul32(ids, 0x9E3779B1)[None, :])
    # 24 high-quality bits -> a uniform strictly inside (0, 1).
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))
