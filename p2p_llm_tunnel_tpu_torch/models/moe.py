"""Mixture-of-experts MLP block — p2p_llm_tunnel_tpu/models/moe.py in
PyTorch: mixtral-style blocks where each layer's MLP is a router over
``n_experts`` per-expert SwiGLUs, top-k routed with renormalized gate
weights.

Compute strategy, as the reference: DENSE-DROPLESS — every expert computes
every token and the router weights (zero for unrouted experts) scale the
combine.  Shapes stay static, nothing is dropped, and the routed math is
reproduced exactly, at ``n_experts / n_experts_per_tok`` times the FLOPs
of a routed gather (4x for mixtral's 8 experts, top 2).  The expert
products are plain batched matrix products, as the reference leaves them to
XLA outside any Pallas kernel, run expert-major on the weights' stored
layout: the ``B*T`` rows, broadcast over the expert axis, meet each
expert's ``[Dm, F]`` (gate, up) and ``[F, Dm]`` (down) slice in place
(``torch.bmm`` over E), and the ``[E, B*T, .]`` activations stay
expert-major up to the combine.  No weight is copied; contracting the
weights' middle axis in one product (``einsum("btd,edf->btef")``) would
re-lay the whole ``[E, Dm, F]`` weight out first.  A routed grouped GEMM
is later work (ROADMAP.md).

Expert parallelism, as the reference's ``moe_pspecs`` sets it up
(``parallel/sharding``): a rank of an ``ep`` mesh holds experts ``[e*E/ep,
(e+1)*E/ep)`` and the whole router.  It routes over all E experts, runs
only its own experts' SwiGLUs, contracts them against its slice of the
router's weight map in f32, and sums that f32 partial over the ep ranks
with one ``all_reduce`` before the cast — where the reference's GSPMD puts
its psum (the f32 expert contraction).  Per-rank expert FLOPs and weight
bytes fall by ep; a token's output is the same sum of its experts.

Pad and parked rows are routed like any row (their outputs are dropped by
the caller); the softmax over the experts' logits is finite for any finite
row, a zero row included (uniform weights).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from p2p_llm_tunnel_tpu_torch.utils.flight import global_flight


def init_moe_blocks(cfg, dense: Callable) -> Dict[str, torch.Tensor]:
    """MoE leaves for the stacked block tree.  ``dense(shape, fan_in, name)``
    is ``init_params``' initializer, so the experts follow the dense
    weights' distribution.  Layout as the reference: router ``[L, Dm, E]``; experts
    ``[L, E, Dm, F]`` (gate/up) and ``[L, E, F, Dm]`` (down)."""
    l, dm, f, e = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    return {
        "router": dense((l, dm, e), dm, "router"),
        "moe_gate": dense((l, e, dm, f), dm, "moe_gate"),
        "moe_up": dense((l, e, dm, f), dm, "moe_up"),
        "moe_down": dense((l, e, f, dm), f, "moe_down"),
    }


def route(cfg, router: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The router's dense weight map ``[B, T, E]`` in f32: softmax over the
    experts' logits (``h @ router`` in f32), top ``n_experts_per_tok``,
    renormalized with a 1e-9 floor, scattered back (zeros for unrouted
    experts).  ``torch.topk`` may break an exact tie of probabilities
    otherwise than ``jax.lax.top_k``; real logits have none."""
    logits = h.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.n_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return torch.zeros_like(probs).scatter_(-1, top_i, top_p)


def moe_mlp(cfg, blk, h: torch.Tensor, act_fn: Callable,
            mesh=None) -> torch.Tensor:
    """Routed MLP for one layer: ``h [B, T, Dm] -> [B, T, Dm]``.  ``blk``
    holds this layer's slice (router ``[Dm, E]``, experts ``[E/ep, ...]``:
    this rank's under an ep ``mesh``).  Every local expert's SwiGLU in
    ``h``'s dtype, the expert axis contracted last in f32 against the
    router's weights, as the reference; under ep the f32 partials are
    summed over the ep ranks (``parallel/collectives.all_reduce_sum``; a
    failed collective raises), and the gradients of ``h`` and of the
    router are summed there too.  With the span journal on, the block is
    one device-timed ``moe`` unit of the flight recorder, nested in the
    engine's decode or prefill unit that runs it (none outside one)."""
    with global_flight.unit("moe"):
        weights = route(cfg, blk["router"], h)
        ep = 1 if mesh is None else mesh.ep
        if ep > 1:
            from p2p_llm_tunnel_tpu_torch.parallel.collectives import (
                all_reduce_sum,
                copy_to_group,
            )

            # Under autograd each rank's cotangents of the whole weight
            # map and of h are the shares of its own experts: summed over
            # ep.
            n = cfg.n_experts // ep
            weights = copy_to_group(weights, mesh.ep_group)
            weights = weights[..., mesh.ep_rank * n:(mesh.ep_rank + 1) * n]
            h = copy_to_group(h, mesh.ep_group)
        b, t, dm = h.shape
        e = blk["moe_gate"].shape[0]
        x = h.reshape(b * t, dm).expand(e, b * t, dm)  # a view, not a copy
        gate = torch.bmm(x, blk["moe_gate"].to(h.dtype))  # [E, N, F]
        up = torch.bmm(x, blk["moe_up"].to(h.dtype))
        inner = act_fn(gate) * up
        down = torch.bmm(inner, blk["moe_down"].to(h.dtype))  # [E, N, Dm]
        out = torch.einsum("end,ne->nd", down.to(torch.float32),
                           weights.reshape(b * t, e))
        if ep > 1:
            out = all_reduce_sum(out, mesh.ep_group)
        return out.reshape(b, t, dm).to(h.dtype)
