"""Mistral-7B and Mixtral-8x7B: the decoder block of both, dense or routed.

As their published descriptions state them: token embedding, then per
layer an RMSNorm, grouped-query attention with rotary positions
(rotate-half, ``rope_theta``) under a causal mask and, where the
configuration sets one, a sliding window on every layer, a residual, a
second RMSNorm and either a SwiGLU MLP or a router over
``num_local_experts`` SwiGLU experts (softmax over the experts' logits, the
top ``num_experts_per_tok`` kept and renormalised, each token computed by
its own experts only), a residual; then the final RMSNorm and the untied
head over the whole vocabulary.

**Weights.**  One ``torch.Generator`` on the device, seeded with
``--seed``, draws every leaf whole in one call (a stacked ``[layers, ...]``
leaf at once), in bfloat16: dense weights normal with standard deviation
``fan_in ** -0.5``, norm weights ``1 + 0.1 * normal`` so the comparison sees
them.  The tree has the layout the served engine takes and the reference
reads; the same tensors go to both.

**Reference.**  The weights widened to float32, every product float32 with
TF32 off (``"fp8"``: float8 operands, the control).  The work runs layer by
layer over all sequences at once (projections and MLPs over the tokens of
every sequence together, attention per sequence in blocks of queries), so
only one layer's widened weights and one block's scores live at a time.

**Work counts.**  Every layer alike, so a count is the layer's times the
layers; the decode attention's bytes are one layer's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from benchmark import roofline
from benchmark.reference.blocks import Ops, attention, rms, rope, swiglu


@dataclass(frozen=True)
class Shape:
    """The sizes a configuration file states, under their published keys."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rope_theta: float
    rms_norm_eps: float
    sliding_window: Optional[int]
    num_local_experts: int
    num_experts_per_tok: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Shape":
        heads = int(cfg["num_attention_heads"])
        return cls(
            vocab_size=int(cfg["vocab_size"]),
            hidden_size=int(cfg["hidden_size"]),
            intermediate_size=int(cfg["intermediate_size"]),
            num_hidden_layers=int(cfg["num_hidden_layers"]),
            num_attention_heads=heads,
            num_key_value_heads=int(cfg["num_key_value_heads"]),
            head_dim=int(cfg.get("head_dim")
                         or int(cfg["hidden_size"]) // heads),
            rope_theta=float(cfg["rope_theta"]),
            rms_norm_eps=float(cfg["rms_norm_eps"]),
            sliding_window=(None if cfg.get("sliding_window") is None
                            else int(cfg["sliding_window"])),
            num_local_experts=int(cfg.get("num_local_experts") or 0),
            num_experts_per_tok=int(cfg.get("num_experts_per_tok") or 0),
        )


def shape(cfg: Dict) -> Shape:
    return Shape.from_config(cfg)


# ---------------------------------------------------------------------------
# Weights

def draw(shape: Shape, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of ``shape`` from ``seed``: same seed, same bytes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def dense(dims, fan_in):
        t = torch.empty(dims, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    def norm(dims):
        t = torch.empty(dims, dtype=dtype, device=device)
        return t.normal_(1.0, 0.1, generator=gen)

    s = shape
    l, d, f = s.num_hidden_layers, s.hidden_size, s.intermediate_size
    q, kv = s.num_attention_heads * s.head_dim, s.num_key_value_heads * s.head_dim
    blocks = {
        "attn_norm": norm((l, d)),
        "mlp_norm": norm((l, d)),
        "wq": dense((l, d, q), d),
        "wk": dense((l, d, kv), d),
        "wv": dense((l, d, kv), d),
        "wo": dense((l, q, d), q),
    }
    if s.num_local_experts:
        e = s.num_local_experts
        blocks.update({
            "router": dense((l, d, e), d),
            "moe_gate": dense((l, e, d, f), d),
            "moe_up": dense((l, e, d, f), d),
            "moe_down": dense((l, e, f, d), f),
        })
    else:
        blocks.update({
            "w_gate": dense((l, d, f), d),
            "w_up": dense((l, d, f), d),
            "w_down": dense((l, f, d), f),
        })
    return {
        "embed": dense((s.vocab_size, d), d),
        "blocks": blocks,
        "final_norm": norm((d,)),
        "lm_head": dense((d, s.vocab_size), d),
    }


# ---------------------------------------------------------------------------
# Plain reference

def _moe(shape: Shape, ops: Ops, blocks, layer: int, h) -> torch.Tensor:
    """Routed experts: each token through its top-k experts only."""
    logits = ops.mm(h, blocks["router"][layer].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, shape.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(shape.num_local_experts):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(ops, h[tok], blocks["moe_gate"][layer, e],
                   blocks["moe_up"][layer, e], blocks["moe_down"][layer, e])
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(shape: Shape, params: Dict, seqs: Sequence[torch.Tensor],
              want: Sequence[Tuple[int, int]], precision: str = "fp32",
              block: int = 512) -> List[torch.Tensor]:
    """Float32 logits ``[stop - start, vocab]`` at positions
    ``[start, stop)`` of each sequence in ``seqs`` (1-D token ids, each from
    position 0).  ``params`` is the weight tree ``draw`` made."""
    ops = Ops(precision)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        blocks = params["blocks"]
        lens = [int(s.numel()) for s in seqs]
        x = torch.cat([params["embed"][s.long()].float() for s in seqs])
        pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
        hd = shape.head_dim
        for layer in range(shape.num_hidden_layers):
            h = rms(x, blocks["attn_norm"][layer], shape.rms_norm_eps)
            q = ops.mm(h, blocks["wq"][layer].float()).view(len(h), -1, hd)
            k = ops.mm(h, blocks["wk"][layer].float()).view(len(h), -1, hd)
            v = ops.mm(h, blocks["wv"][layer].float()).view(len(h), -1, hd)
            q = rope(q, pos, shape.rope_theta)
            k = rope(k, pos, shape.rope_theta)
            att, a = [], 0
            for n in lens:
                att.append(attention(ops, q[a:a + n], k[a:a + n], v[a:a + n],
                                     shape.sliding_window, block))
                a += n
            del q, k, v
            x = x + ops.mm(torch.cat(att), blocks["wo"][layer].float())
            del att
            h = rms(x, blocks["mlp_norm"][layer], shape.rms_norm_eps)
            if shape.num_local_experts:
                x = x + _moe(shape, ops, blocks, layer, h)
            else:
                x = x + swiglu(ops, h, blocks["w_gate"][layer],
                               blocks["w_up"][layer], blocks["w_down"][layer])
            del h
        out, a = [], 0
        head = params["lm_head"].float()
        for n, (start, stop) in zip(lens, want):
            h = rms(x[a + start:a + stop], params["final_norm"],
                    shape.rms_norm_eps)
            out.append(ops.mm(h, head))
            a += n
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# The port's engine

#: Published configuration keys -> the port's ModelConfig fields.
MODEL_FIELDS = {
    "vocab_size": "vocab_size", "hidden_size": "dim",
    "intermediate_size": "ffn_dim", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "sliding_window": "sliding_window",
    "num_local_experts": "n_experts", "num_experts_per_tok": "n_experts_per_tok",
}


def model_fields(cfg: Dict) -> Dict:
    """Every size the file states, as the port's ModelConfig fields."""
    s = shape(cfg)
    return {field: getattr(s, key) for key, field in MODEL_FIELDS.items()}


# ---------------------------------------------------------------------------
# Work counts

def matmul_flops_per_token(shape: Shape) -> float:
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


def head_flops(shape: Shape) -> float:
    """The head's product for one token (its logits over the vocabulary)."""
    return 2.0 * shape.hidden_size * shape.vocab_size


def attention_flops(shape: Shape, context: int) -> float:
    """Scores and the weighted sum for one query token that sees
    ``context`` keys (itself included), over every layer and head."""
    if shape.sliding_window is not None:
        context = min(context, shape.sliding_window)
    return 4.0 * shape.num_hidden_layers * shape.num_attention_heads \
        * shape.head_dim * context


def prefill_flops(shape: Shape, start: int, stop: int) -> float:
    """Computing positions ``[start, stop)`` of a prompt whose positions
    below ``start`` come from a cache: every weight product, attention over
    each position's causal context, and the head once (the first token)."""
    n = max(0, stop - start)
    if n == 0:
        return 0.0
    ctx = roofline.context_sum(start, stop, shape.sliding_window)
    return (n * matmul_flops_per_token(shape) + head_flops(shape)
            + 4.0 * shape.num_hidden_layers * shape.num_attention_heads
            * shape.head_dim * ctx)


def decode_flops(shape: Shape, position: int) -> float:
    """One decode step of one row whose new token sits at ``position``."""
    return (matmul_flops_per_token(shape) + head_flops(shape)
            + attention_flops(shape, position + 1))


def decode_attention_bytes(shape: Shape, position: int) -> float:
    """Bytes one layer's fused decode attention needs for one row whose new
    token sits at ``position``: the cached keys and values of positions
    ``[0, position)`` read once (within the window), the new token's q, k
    and v read once, its k and v written into the cache once, and the
    attention output written once; bf16 throughout."""
    ctx = position
    if shape.sliding_window is not None:
        ctx = min(ctx, shape.sliding_window - 1)
    kv_row = shape.num_key_value_heads * shape.head_dim * roofline.BF16
    q_row = shape.num_attention_heads * shape.head_dim * roofline.BF16
    return 2 * kv_row * ctx + (q_row + 2 * kv_row) + 2 * kv_row + q_row


def burst_bytes(shape: Shape, rows: Iterable[Tuple[int, int]]) -> float:
    """Per-layer bytes of a decode burst: ``rows`` of ``(first position,
    steps)``, each step at the next position."""
    total = 0.0
    for pos, steps in rows:
        for p in range(pos, pos + steps):
            total += decode_attention_bytes(shape, p)
    return total
