"""Ring attention: causal self-attention over a sequence-sharded sp group
(port of p2p_llm_tunnel_tpu/ops/ring_attention.py).

Long-context prefill beyond one card's memory: each rank keeps its query
block resident while the K/V blocks travel one hop around the ring per
step (``parallel/collectives.ring_shift``), and an online (flash-style)
softmax accumulates the output, so the full score matrix never exists.
Per step each rank holds one K/V block and updates

    m_new = max(m, rowmax(scores))
    acc   = acc * exp(m - m_new) + exp(scores - m_new) @ V
    l     = l * exp(m - m_new) + rowsum(exp(scores - m_new))

Causality is enforced with global positions, so a block that lies wholly
in the future contributes nothing (its scores mask to ``_NEG_INF``).

The reference computes this outside Pallas (einsums inside ``shard_map``),
and so does the port: the block products are ``torch.einsum`` in f32 on
either device; no kernel runs here.  A rank runs ``sp`` steps a layer and
passes its K/V block on after every step but the last (the reference's
scan also rotates after the last step, which brings each block home and
is read by no one).
"""

from __future__ import annotations

from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.parallel.collectives import ring_shift

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _block_scores(
    q: torch.Tensor,  # [B, Tq, K, G, D]
    k: torch.Tensor,  # [B, Tk, K, D]
    scale: float,
    softcap: Optional[float],
    q_pos: torch.Tensor,  # [Tq] global positions
    k_pos: torch.Tensor,  # [Tk] global positions
) -> torch.Tensor:
    """Causally masked f32 scores ``[B, K, G, Tq, Tk]``."""
    scores = torch.einsum("btkgd,bskd->bkgts", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = k_pos[None, :] <= q_pos[:, None]  # [Tq, Tk] causal
    return torch.where(mask[None, None, None], scores, _NEG_INF)


def ring_attention(
    q: torch.Tensor,  # [B, Tq, H, D] this rank's query block
    k: torch.Tensor,  # [B, Tk, K, D] this rank's key block
    v: torch.Tensor,  # [B, Tk, K, D]
    *,
    group,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One rank's program of causal GQA ring attention over the sp
    ``group``: this rank holds sequence block ``rank`` of every input and
    gets that block of the output, ``[B, Tq, H, D]`` in q's dtype.  Every
    rank of the group must call it with blocks of one shape."""
    import torch.distributed as dist

    b, tq, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    g = h // kh
    s = scale if scale is not None else d**-0.5
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dev = q.device

    q5 = q.reshape(b, tq, kh, g, d)
    q_pos = me * tq + torch.arange(tq, device=dev)
    acc = torch.zeros((b, kh, g, tq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kh, g, tq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (me - step) % n  # the rank whose block this is
        k_pos = src * tk + torch.arange(tk, device=dev)
        sc = _block_scores(q5, k_blk, s, softcap, q_pos, k_pos)  # [B,K,G,Tq,Tk]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # All-masked rows keep m == _NEG_INF; exp(m - m_new) would be 1
        # there, so the correction of rows that have seen nothing is 0.
        corr = torch.where(m == _NEG_INF, 0.0, torch.exp(m - m_new))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc == _NEG_INF, 0.0, p)
        del sc
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", p, v_blk.to(torch.float32))
        l = l * corr + p.sum(dim=-1)
        m = m_new
        del p
        if step + 1 < n:
            k_blk = ring_shift(k_blk, group)
            v_blk = ring_shift(v_blk, group)

    out = acc / torch.clamp(l[..., None], min=1e-30)  # [B,K,G,Tq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).to(q.dtype)


def ring_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, scale: Optional[float] = None, softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-device causal GQA attention — the numerics oracle."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    s = scale if scale is not None else d**-0.5
    q5 = q.reshape(b, t, kh, g, d)
    pos = torch.arange(t, device=q.device)
    scores = _block_scores(q5, k, s, softcap, pos, pos)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(torch.float32))
    return out.reshape(b, t, h, d).to(q.dtype)
