"""Plain float32 forward pass of the decoders the benchmark serves.

Mistral-7B and Mixtral-8x7B as their published descriptions state them:
token embedding, then per layer an RMSNorm, grouped-query attention with
rotary positions (rotate-half, ``rope_theta``) under a causal mask and,
where the configuration sets one, a sliding window (a query at position i
sees keys j with ``i - window < j <= i``), a residual, a second RMSNorm and
either a SwiGLU MLP or a router over ``num_local_experts`` SwiGLU experts
(softmax over the experts' logits, the top ``num_experts_per_tok`` kept and
renormalised, each token computed by its own experts only), a residual;
then the final RMSNorm and the untied head over the whole vocabulary.

Weights are the benchmark's own draw (``benchmark/weights.py``): stored in
bfloat16, widened here to float32, and every product is float32 with TF32
off.  Nothing of the served program is imported.  The work runs layer by
layer over all sequences at once (projections and MLPs over the tokens of
every sequence together, attention per sequence in blocks of queries), so
only one layer's widened weights and one block's scores live at a time.

``precision="fp8"`` is the control: the same arithmetic with every operand
of every product rounded to float8 e4m3 first (per-row scales on the
activations, per-column scales on the weights, fp32 accumulation), the
precision a quantised serving path would use below the configuration's
bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: Largest finite float8 e4m3 value.
_FP8_MAX = 448.0


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


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the reduction axis of the product it feeds), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ops:
    """The products of one precision: float32, or float8 operands."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a [N, K] @ w [K, M]``."""
        if self.fp8:
            a, w = _fp8(a, -1), _fp8(w, 0)
        return a @ w

    def scores(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """``q [H, Q, D]`` against ``k [H, T, D]``: ``[H, Q, T]``."""
        if self.fp8:
            q, k = _fp8(q, -1), _fp8(k, -1)
        return q @ k.transpose(1, 2)

    def mix(self, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``p [H, Q, T] @ v [H, T, D]``."""
        if self.fp8:
            p, v = _fp8(p, -1), _fp8(v, 1)
        return p @ v


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x [T, heads, D]`` at ``pos [T]``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(shape: Shape, ops: _Ops, q, k, v, block: int) -> torch.Tensor:
    """Causal (and windowed) attention of one sequence: ``q [T, H, D]``,
    ``k``/``v [T, KH, D]`` -> ``[T, H * D]``, in blocks of queries."""
    t, h, d = q.shape
    g = h // shape.num_key_value_heads
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
        if shape.sliding_window is not None:
            allowed = allowed & (rows - keys[None, :b] < shape.sliding_window)
        s = s.masked_fill(~allowed[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = ops.mix(p, vh[:, :b]).transpose(0, 1)
    return out.reshape(t, h * d)


def _swiglu(ops: _Ops, x, gate, up, down) -> torch.Tensor:
    return ops.mm(torch.nn.functional.silu(ops.mm(x, gate.float()))
                  * ops.mm(x, up.float()), down.float())


def _moe(shape: Shape, ops: _Ops, blocks, layer: int, h) -> torch.Tensor:
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
        y = _swiglu(ops, h[tok], blocks["moe_gate"][layer, e],
                    blocks["moe_up"][layer, e], blocks["moe_down"][layer, e])
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(shape: Shape, params: Dict, seqs: Sequence[torch.Tensor],
              want: Sequence[Tuple[int, int]], precision: str = "fp32",
              block: int = 512) -> List[torch.Tensor]:
    """Float32 logits ``[stop - start, vocab]`` at positions
    ``[start, stop)`` of each sequence in ``seqs`` (1-D token ids, each from
    position 0).  ``params`` is the weight tree the benchmark drew."""
    ops = _Ops(precision)
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
            h = _rms(x, blocks["attn_norm"][layer], shape.rms_norm_eps)
            q = ops.mm(h, blocks["wq"][layer].float()).view(len(h), -1, hd)
            k = ops.mm(h, blocks["wk"][layer].float()).view(len(h), -1, hd)
            v = ops.mm(h, blocks["wv"][layer].float()).view(len(h), -1, hd)
            q = _rope(q, pos, shape.rope_theta)
            k = _rope(k, pos, shape.rope_theta)
            att, a = [], 0
            for n in lens:
                att.append(_attention(shape, ops, q[a:a + n], k[a:a + n],
                                      v[a:a + n], block))
                a += n
            del q, k, v
            x = x + ops.mm(torch.cat(att), blocks["wo"][layer].float())
            del att
            h = _rms(x, blocks["mlp_norm"][layer], shape.rms_norm_eps)
            if shape.num_local_experts:
                x = x + _moe(shape, ops, blocks, layer, h)
            else:
                x = x + _swiglu(ops, h, blocks["w_gate"][layer],
                                blocks["w_up"][layer], blocks["w_down"][layer])
            del h
        out, a = [], 0
        head = params["lm_head"].float()
        for n, (start, stop) in zip(lens, want):
            h = _rms(x[a + start:a + stop], params["final_norm"],
                     shape.rms_norm_eps)
            out.append(ops.mm(h, head))
            a += n
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
