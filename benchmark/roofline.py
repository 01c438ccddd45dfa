"""Peaks of the card and the operations and bytes the model's work needs.

The yardstick of the benchmark's shares of a roofline or of a peak: the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), and the operation and byte counts of the served models computed
from their shapes alone.  The arithmetic of a kernel's bound follows
``chip_smoke.py``'s phase 2 (each input byte read once, each output byte
written once; the bound is the larger of bytes over the memory rate and
operations over the compute rate).
"""

from __future__ import annotations

from typing import Iterable, Tuple

#: One H100 SXM: dense bf16 tensor rate and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

BF16 = 2


def matmul_flops_per_token(shape) -> float:
    """Multiply-adds x 2 of one token through every weight product of the
    model: the projections, the MLP (only the ``num_experts_per_tok``
    experts a token is routed to, and the router); the head is apart
    (``head_flops``)."""
    s = shape
    d, f = s.hidden_size, s.intermediate_size
    q = s.num_attention_heads * s.head_dim
    kv = s.num_key_value_heads * s.head_dim
    attn = d * q + 2 * d * kv + q * d
    if s.num_local_experts:
        mlp = s.num_experts_per_tok * 3 * d * f + d * s.num_local_experts
    else:
        mlp = 3 * d * f
    return 2.0 * s.num_hidden_layers * (attn + mlp)


def head_flops(shape) -> float:
    """The head's product for one token (its logits over the vocabulary)."""
    return 2.0 * shape.hidden_size * shape.vocab_size


def attention_flops(shape, context: int) -> float:
    """Scores and the weighted sum for one query token that sees
    ``context`` keys (itself included), over every layer and head."""
    if shape.sliding_window is not None:
        context = min(context, shape.sliding_window)
    return 4.0 * shape.num_hidden_layers * shape.num_attention_heads \
        * shape.head_dim * context


def _context_sum(start: int, stop: int, window) -> int:
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


def prefill_flops(shape, start: int, stop: int) -> float:
    """Computing positions ``[start, stop)`` of a prompt whose positions
    below ``start`` come from a cache: every weight product, attention over
    each position's causal context, and the head once (the first token)."""
    n = max(0, stop - start)
    if n == 0:
        return 0.0
    ctx = _context_sum(start, stop, shape.sliding_window)
    return (n * matmul_flops_per_token(shape) + head_flops(shape)
            + 4.0 * shape.num_hidden_layers * shape.num_attention_heads
            * shape.head_dim * ctx)


def decode_flops(shape, position: int) -> float:
    """One decode step of one row whose new token sits at ``position``."""
    return (matmul_flops_per_token(shape) + head_flops(shape)
            + attention_flops(shape, position + 1))


def decode_attention_bytes(shape, position: int) -> float:
    """Bytes one layer's fused decode attention needs for one row whose new
    token sits at ``position``: the cached keys and values of positions
    ``[0, position)`` read once (within the window), the new token's q, k
    and v read once, its k and v written into the cache once, and the
    attention output written once; bf16 throughout."""
    ctx = position
    if shape.sliding_window is not None:
        ctx = min(ctx, shape.sliding_window - 1)
    kv_row = shape.num_key_value_heads * shape.head_dim * BF16
    q_row = shape.num_attention_heads * shape.head_dim * BF16
    return 2 * kv_row * ctx + (q_row + 2 * kv_row) + 2 * kv_row + q_row


def burst_bytes(shape, rows: Iterable[Tuple[int, int]]) -> float:
    """Per-layer bytes of a decode burst: ``rows`` of ``(first position,
    steps)``, each step at the next position."""
    total = 0.0
    for pos, steps in rows:
        for p in range(pos, pos + steps):
            total += decode_attention_bytes(shape, p)
    return total
