"""KV-cache quantization helpers — the KV half of
p2p_llm_tunnel_tpu/models/quant.py in PyTorch.

int4 packing: two int4 values per int8 byte along one axis, element 2i in
the low nibble and 2i+1 in the high nibble (the reference's layout, so a
packed cache means the same bytes in both packages).  The KV cache packs
along the SEQUENCE axis: byte i of a slot row holds tokens 2i and 2i+1.

Every write into a packed plane goes through one of the four helpers
below, and each stores WHOLE bytes: a nibble shared with a neighbouring
token is merged from the byte read back, never half-written.  Unlike the
reference (functional ``.at[].set``), they write IN PLACE and return the
plane.  Rows past the plane's end (parked slots, a padded tail or a verify
burst beyond ``max_seq``) rewrite a byte of their own row with its old
value where XLA's scatter would drop the write — torch indexing past the
end faults on the card.

Weight quantization (``QTensor``, ``QTensor4``, w8a8) is not ported here
(ROADMAP.md, port queue: weight quantization).
"""

from __future__ import annotations

from typing import Tuple

import torch


def pack_int4(vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int values in [-8, 7] two per byte along ``axis`` (even size):
    element 2i -> low nibble, 2i+1 -> high nibble."""
    axis = axis % vals.dim()
    n = vals.shape[axis]
    if n % 2:
        raise ValueError(f"pack_int4 needs an even axis size, got {n}")
    v = vals.to(torch.int16)
    pairs = v.unflatten(axis, (n // 2, 2))
    lo = pairs.select(axis + 1, 0)
    hi = pairs.select(axis + 1, 1)
    # hi * 16 + low nibble lies in [-128, 127] for hi in [-8, 7]: the int8
    # cast is exact (the reference's (hi << 4) | (lo & 0x0F) on int8).
    return (hi * 16 + (lo & 0x0F)).to(torch.int8)


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) nibbles of int8 bytes as sign-extended int8 values."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4  # arithmetic: the sign of the byte is the high nibble's
    return lo.to(torch.int8), hi.to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: int8 bytes -> int8 values in [-8, 7], the
    packed axis doubling (token 2i from the low nibble, 2i+1 from the
    high)."""
    axis = axis % packed.dim()
    lo, hi = _nibbles(packed)
    return torch.stack([lo, hi], dim=axis + 1).flatten(axis, axis + 1)


def write_packed_prefix(plane: torch.Tensor, slots: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Full-prefix packed write, IN PLACE: ``vals [L, Bp, T(even), K, D]``
    int4 values land at token positions ``[0, T)`` of each slot row of
    ``plane [L, R, S//2, K, D]`` — whole bytes from position 0."""
    packed = pack_int4(vals, axis=2)
    plane[:, slots.to(torch.long), : packed.shape[2]] = packed
    return plane


def write_packed_chunk(plane: torch.Tensor, idx: int, rows: torch.Tensor,
                       bpos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Page-aligned chunk write, IN PLACE: ``vals [Bp, T(even), K, D]`` at
    even token starts, given as byte positions ``bpos [Bp, T//2]`` (byte i
    holds tokens ``start + 2i, start + 2i + 1``).  ``rows [Bp, 1]`` are
    the slots.  Bytes past the plane (a padded tail beyond ``max_seq``)
    rewrite their row's own old byte ``T//2`` bytes earlier — a history
    byte no real write of this call touches."""
    half = bpos.shape[1]
    nbytes = plane.shape[2]
    inside = bpos < nbytes
    wpos = torch.where(inside, bpos, (bpos - half).clamp(min=0)).to(torch.long)
    rows = rows.to(torch.long)
    old = plane[idx, rows, wpos]
    plane[idx, rows, wpos] = torch.where(
        inside[:, :, None, None], pack_int4(vals, axis=1), old)
    return plane


def append_packed_token(plane: torch.Tensor, idx: int, slots: torch.Tensor,
                        positions: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Single-token decode append, IN PLACE: ``vals [B, K, D]`` at
    arbitrary-parity ``positions [B]``.  The new token shares its byte with
    its sequence neighbour, whose nibble must survive: read the covering
    byte, merge the new nibble, store the whole byte.  Rows at positions
    past the plane write their (clamped) byte back unchanged."""
    nbytes = plane.shape[2]
    pos = positions.to(torch.long)
    inside = (pos < 2 * nbytes)[:, None, None]
    bidx = (pos // 2).clamp(max=nbytes - 1)
    slots = slots.to(torch.long)
    old = plane[idx, slots, bidx]  # [B, K, D]
    even = (pos % 2 == 0)[:, None, None]
    old_lo, old_hi = _nibbles(old)
    lo = torch.where(even, vals.to(torch.int8), old_lo).to(torch.int16)
    hi = torch.where(even, old_hi, vals.to(torch.int8)).to(torch.int16)
    merged = (hi * 16 + (lo & 0x0F)).to(torch.int8)
    plane[idx, slots, bidx] = torch.where(inside, merged, old)
    return plane


def splice_packed_rows(plane: torch.Tensor, idx: int, slots: torch.Tensor,
                       starts: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """Arbitrary-start multi-token splice, IN PLACE — the write shape of a
    speculative verify burst: ``vals [B, T, K, D]`` int4 values land at
    token positions ``[starts, starts + T)`` of each slot row, ``starts
    [B]`` of any parity and ``T`` of any parity.  The covering bytes (``T//2
    + 1`` of them span every parity case) are read, unpacked, overlaid with
    the burst's tokens and repacked, and the same whole bytes are stored:
    nibbles outside the burst keep their old value.  Bytes past the plane
    (parked rows at ``start = max_seq``, a burst crossing the end) rewrite
    their row's own old byte ``T//2 + 1`` bytes earlier, before the burst's
    first byte, where XLA's scatter would drop them (the plane must hold
    more than ``2 * (T//2 + 1)`` bytes per row)."""
    b, t = vals.shape[:2]
    nb = t // 2 + 1
    nbytes = plane.shape[2]
    start = starts.to(torch.long)
    bpos = start[:, None] // 2 + torch.arange(nb, device=start.device)[None, :]
    inside = bpos < nbytes  # [B, nb]
    wpos = torch.where(inside, bpos, (bpos - nb).clamp(min=0))
    rows = slots.to(torch.long)[:, None]
    old = plane[idx, rows, wpos]  # [B, nb, K, D]
    old_tok = unpack_int4(old, axis=1)  # [B, 2nb, K, D]
    jrel = (torch.arange(2 * nb, device=start.device)[None, :]
            - (start % 2)[:, None])  # [B, 2nb] burst offset of each token
    use_new = (jrel >= 0) & (jrel < t)
    newv = vals[torch.arange(b, device=start.device)[:, None], jrel.clamp(0, t - 1)]
    merged = torch.where(use_new[:, :, None, None], newv.to(torch.int8), old_tok)
    plane[idx, rows, wpos] = torch.where(
        inside[:, :, None, None], pack_int4(merged, axis=1), old)
    return plane


def quantize_sym(x: torch.Tensor, qmax: float):
    """Symmetric quantization over the last axis -> (values in [-qmax,
    qmax] as f32, scale f32 ``[..., 1]``): scale = max(amax, 1e-8) / qmax,
    values = round(x / scale) clipped — the reference's formula, with the
    IEEE division ``x / scale`` (never a reciprocal multiply) and
    round-half-to-even, so the kernels' quantizers match it bit for bit.
    ``qmax`` divides as a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can move the scale by one
    ulp."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-8) / torch.full_like(amax, qmax)
    return torch.clamp(torch.round(xf / scale), -qmax, qmax), scale


def _quantize_act(x: torch.Tensor):
    """Dynamic per-token symmetric int8 quantization over the last axis:
    ``(xq int8, scale f32 [..., 1])``."""
    xq, xs = quantize_sym(x, 127.0)
    return xq.to(torch.int8), xs
