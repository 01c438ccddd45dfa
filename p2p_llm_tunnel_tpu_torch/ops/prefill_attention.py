"""Ragged grouped prefill attention: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py
``ragged_prefill_attention`` in its raw-KV form.

One launch per layer covers a whole admission group.  The group's
variable-length tail segments are flat-packed along one token axis — row
``r``'s tail occupies ``[flat_off_r, flat_off_r + len_r)``, each row
rounded up to a ``block_q`` multiple — and every q-block carries ``(slot,
start, qoff, base)`` descriptors (:func:`plan_ragged_group`, copied from
the reference).  Per q-block the kernel ropes q and the tail K at global
positions ``start + qoff + i``, appends the block's own roped K/V rows into
the ``[L, B, S, K, D]`` cache IN PLACE, and attends each query to its row's
cache history ``[0, start)`` plus its row's own tail, causally.

The kernel is ``csrc/ragged_prefill_attention.cu`` (CUDA C++, sm_90a,
built at first use and loaded with ctypes — see ``ops/kernel_build.py``).
Its plain version is :func:`ragged_prefill_plain` below: per row it ropes,
writes the cache and runs ``ops/attention.history_attention`` over the
cache row.  The wrapper runs the plain version for tensors on the CPU, and
only because they lie on the CPU; for CUDA tensors it launches the kernel
or raises.  Both take RoPE from one ``ops/rope.rope_table`` table, so they
agree on it exactly.  The int8/int4 cache forms of the TPU kernel are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import history_attention
from p2p_llm_tunnel_tpu_torch.ops.rope import rope_table

_NAME = "ragged_prefill_attention"
_SUPPORTED_D = (16, 32, 64, 128, 256)  # every preset's head_dim
#: ``window=None``: no key is ever too old.
_NO_WINDOW = 2**31 - 1

#: Default q-block width: the default prefix-cache page size, so every
#: chunk start (a page or segment multiple) is block-aligned.
RAGGED_BLOCK_Q = 16


def plan_ragged_group(
    entries: Sequence[Tuple[int, int, int]],
    block_q: int,
    tot: int,
    scratch_slot: int,
    max_row_blocks: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           List[int]]:
    """Pure host planner for one grouped launch: pack ``entries`` of
    ``(slot, start, tail_len)`` rows into a ``tot``-token flat buffer.

    Each row's tail is placed at the next ``block_q``-aligned flat offset;
    the remaining blocks are PAD blocks pointing at the scratch slot (zero
    length, self-based; their append lands in the scratch row — junk by
    definition).  Returns the per-block descriptor arrays ``(slot_of,
    start_of, qoff_of, qlen_of, base_of)`` plus each row's flat token
    offset.  Raises when the group does not fit ``tot`` or a start violates
    the ``block_q`` alignment the cache-append blocks require.
    """
    if tot % block_q:
        raise ValueError(f"tot {tot} not a multiple of block_q {block_q}")
    nqb = tot // block_q
    slot_of = np.full((nqb,), scratch_slot, np.int32)
    start_of = np.zeros((nqb,), np.int32)
    qoff_of = np.zeros((nqb,), np.int32)
    qlen_of = np.zeros((nqb,), np.int32)
    base_of = np.arange(nqb, dtype=np.int32)  # pad blocks: self-based
    flat_offs: List[int] = []
    blk = 0
    for slot, start, tail_len in entries:
        if tail_len <= 0:
            raise ValueError("ragged group rows need tail_len >= 1")
        if start % block_q:
            raise ValueError(
                f"ragged prefill start {start} is not a multiple of the "
                f"q-block width {block_q}: chunk starts must be page/"
                f"segment multiples (the page-alignment contract)"
            )
        n_blocks = -(-tail_len // block_q)
        if max_row_blocks and n_blocks > max_row_blocks:
            raise ValueError(
                f"row tail of {tail_len} tokens exceeds the kernel's "
                f"{max_row_blocks}-block per-row bound"
            )
        if (blk + n_blocks) * block_q > tot:
            raise ValueError(
                f"ragged group overflows the {tot}-token flat bucket"
            )
        flat_offs.append(blk * block_q)
        for j in range(n_blocks):
            slot_of[blk + j] = slot
            start_of[blk + j] = start
            qoff_of[blk + j] = j * block_q
            qlen_of[blk + j] = tail_len
            base_of[blk + j] = blk
        blk += n_blocks
    return slot_of, start_of, qoff_of, qlen_of, base_of, flat_offs


_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(s: int, d: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) ``[s, d/2]`` fp32 for positions ``0..s-1`` from
    ``ops/rope.rope_table`` — the one table kernel and plain version both
    rope with (built once per geometry and device)."""
    key = (s, d, float(theta), str(torch.device(device)))
    tab = _TABLES.get(key)
    if tab is None:
        pos = torch.arange(s, device=device)
        sin, cos = rope_table(pos, d, theta)
        tab = _TABLES[key] = (sin.contiguous(), cos.contiguous())
    return tab


def _rope_rows(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """ops/rope.apply_rope's expression on rows ``x [N, heads, D]`` with
    table rows ``sin/cos [N, D/2]``."""
    s = sin[:, None, :]
    c = cos[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _rows_of(base_of: Sequence[int]) -> List[Tuple[int, int]]:
    """[(first q-block, block count)] of each row: the runs of q-blocks
    sharing a base (a pad block is a one-block row of its own)."""
    rows: List[Tuple[int, int]] = []
    j = 0
    while j < len(base_of):
        end = j + 1
        while end < len(base_of) and base_of[end] == base_of[j]:
            end += 1
        rows.append((j, end - j))
        j = end
    return rows


def ragged_prefill_plain(
    q, k_new, v_new, k_cache, v_cache, slot_of, start_of, qoff_of, base_of,
    layer_idx, *, block_q: int = RAGGED_BLOCK_Q, rope_theta: float,
    scale: Optional[float] = None, softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version (same function, same layouts):
    per row, rope q and the tail K from the shared table, write the tail
    K/V into ``cache[layer, slot, start:start+n]`` IN PLACE, and run
    ``history_attention`` over the cache row.  Pad tokens of a row's last
    block are part of its tail (causally after every real token)."""
    tot, _, d = q.shape
    s = k_cache.shape[2]
    layer = int(layer_idx)
    sin, cos = rope_tables(s, d, rope_theta, q.device)
    slots, starts, bases = (x.tolist() for x in (slot_of, start_of, base_of))
    out = torch.empty_like(q)
    for first, nblk in _rows_of(bases):
        t0, n = first * block_q, nblk * block_q
        st, sl = int(starts[first]), int(slots[first])
        pos = torch.arange(st, st + n, device=q.device)
        qr = _rope_rows(q[t0:t0 + n], sin[pos], cos[pos])
        kr = _rope_rows(k_new[t0:t0 + n], sin[pos], cos[pos])
        k_cache[layer, sl, st:st + n] = kr
        v_cache[layer, sl, st:st + n] = v_new[t0:t0 + n]
        out[t0:t0 + n] = history_attention(
            qr[None], k_cache[layer, sl][None], v_cache[layer, sl][None],
            torch.tensor([st], device=q.device),
            scale=scale, softcap=softcap, window=window,
        )[0]
    return out


#: The kernel's plain PyTorch version.
plain = ragged_prefill_plain


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.ragged_prefill_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check_geometry(q, k_new, v_new, k_cache, v_cache, descs, block_q) -> None:
    if q.dim() != 3 or k_new.dim() != 3 or k_new.shape != v_new.shape:
        raise ValueError("ragged_prefill_attention takes q [TOT,H,D], k/v_new [TOT,K,D]")
    tot, h, d = q.shape
    if k_new.shape[0] != tot or k_new.shape[2] != d or h % k_new.shape[1]:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not match q {tuple(q.shape)}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v cache must be matching [L,B,S,K,D] tensors")
    if tuple(k_cache.shape[3:]) != tuple(k_new.shape[1:]):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match k_new {tuple(k_new.shape)}")
    if tot % block_q:
        raise ValueError(f"flat length {tot} not a multiple of block_q {block_q}")
    if k_cache.shape[2] % block_q:
        raise ValueError(
            f"max_seq {k_cache.shape[2]} is not a multiple of block_q "
            f"{block_q}: the cache-append blocks would overrun the cache")
    nqb = tot // block_q
    for x in descs:
        if tuple(x.shape) != (nqb,):
            raise ValueError(f"descriptor arrays must be [{nqb}] (one per q-block)")
    start_of = descs[1]
    if start_of.device.type == "cpu" and bool((start_of % block_q != 0).any()):
        raise ValueError(f"ragged prefill starts must be multiples of block_q {block_q}")


def _check_kernel(q, k_new, v_new, k_cache, v_cache, descs) -> None:
    d = q.shape[2]
    if d not in _SUPPORTED_D:
        raise ValueError(f"ragged_prefill_attention kernel supports head_dim {_SUPPORTED_D}, got {d}")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"ragged_prefill_attention kernel takes bfloat16 {name}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"ragged_prefill_attention kernel needs a contiguous, 16-byte aligned {name}")
    for x in descs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("descriptor arrays must be contiguous int32 tensors")
    devices = {x.device for x in (q, k_new, v_new, k_cache, v_cache, *descs)}
    if len(devices) != 1:
        raise ValueError(f"ragged_prefill_attention inputs span devices {devices}")


def ragged_prefill_attention(
    q: torch.Tensor,        # [TOT, H, D] flat-packed tail queries, PRE-rope
    k_new: torch.Tensor,    # [TOT, K, D] flat-packed new keys, PRE-rope
    v_new: torch.Tensor,    # [TOT, K, D]
    k_cache: torch.Tensor,  # [L, B, S, K, D], written in place
    v_cache: torch.Tensor,
    slot_of: torch.Tensor,  # [NQB] int32 descriptors (plan_ragged_group)
    start_of: torch.Tensor,
    qoff_of: torch.Tensor,
    base_of: torch.Tensor,
    layer_idx: int,
    *,
    block_q: int = RAGGED_BLOCK_Q,
    rope_theta: float,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged grouped prefill over one layer -> attention ``[TOT, H, D]``;
    the cache's ``[layer]`` plane gets each q-block's roped K and V rows
    appended in place.  ``window`` is a per-layer Python int (None = no
    window)."""
    descs = (slot_of, start_of, qoff_of, base_of)
    _check_geometry(q, k_new, v_new, k_cache, v_cache, descs, block_q)
    if q.device.type == "cpu":
        return plain(q, k_new, v_new, k_cache, v_cache, *descs, layer_idx,
                     block_q=block_q, rope_theta=rope_theta, scale=scale,
                     softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_prefill_attention runs on cuda or cpu, not {q.device}")
    _check_kernel(q, k_new, v_new, k_cache, v_cache, descs)
    tot, h, d = q.shape
    n_layers, b, s, kh, _ = k_cache.shape
    layer = int(layer_idx)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the cache's {n_layers} layers")
    if scale is None:
        scale = d**-0.5
    sin, cos = rope_tables(s, d, rope_theta, q.device)
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ragged_prefill_attention_bf16(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), sin.data_ptr(),
            cos.data_ptr(), slot_of.data_ptr(), start_of.data_ptr(),
            qoff_of.data_ptr(), base_of.data_ptr(), out.data_ptr(),
            tot // block_q, h, kh, d, block_q, b, s, layer, float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    ragged_prefill_attention.launches += 1
    return out


#: Kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the engine and reads it after).
ragged_prefill_attention.launches = 0
