"""Ragged grouped prefill attention: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py
``ragged_prefill_attention`` in its raw, int8 and packed-int4 KV forms.

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
built at first use and loaded with ctypes — see ``ops/kernel_build.py``):
kernel 1's tile loop (``mma.sync`` with S/P/O in registers, ``cp.async``
double-buffered K/V tiles, masks only on the tiles that need them) over
each row's cache history and then its tail.  One block's query tile spans
:func:`q_blocks_per_tile` consecutive q-blocks of a row, so a row's
history is read once per (query tile, KV head); the launch grid is one
block per (q-block, KV head, row chunk), computable without reading the
descriptors, and only a tile's first q-block runs it
(:func:`query_tiles` is the same rule on the host).
Its plain version is :func:`ragged_prefill_plain` below: per row it ropes,
writes the cache and runs ``ops/attention.history_attention`` over the
cache row.  The wrapper runs the plain version for tensors on the CPU, and
only because they lie on the CPU; for CUDA tensors it launches the kernel
or raises.  Both take RoPE from one ``ops/rope.rope_table`` table, so they
agree on it exactly.

Quantized caches (``kv_quant="int8"``: int8 ``[L, B, S, K, D]``;
``"int4"``: ``[L, B, S/2, K, D]`` bytes, token 2i in the low nibble of byte
i; both with f32 ``[L, B, S, K]`` scales).  The plain version follows the
Pallas body's rounding points, which differ from kernels 2 and 4; the
kernel appends the same bytes and scales bit for bit, and attends in
another order (the integers feed its bf16 products, the scales ride on the
scores and on P), within the kernels' tolerance:
- history is dequantized in f32 and then rounded through the activation
  dtype (the chunk path's view read);
- the tail's keys are quantized from their f32 rope (values from
  ``v_new``), and attention uses the quantize -> dequantize roundtrip of
  the tail, rounded through the activation dtype the same way;
- the append writes whole bytes (every start and ``block_q`` are even
  under int4) with the scales beside them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.models.quant import pack_int4, quantize_sym
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import history_attention
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import (
    INT4_PACK_TOKENS,
    KV_FORMS,
    _form,
    dequant_f32,
)
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


#: Keys per tile and bf16 row padding of the kernel's shared tiles.
_BK = 64
_PAD = 8


def block_rows(d: int) -> int:
    """Query rows one block of the kernel holds: 8 warps of 16, 4 warps at
    head dim 256 (where two K/V stages take 132 KB of shared memory)."""
    return 64 if d > 128 else 128


def q_blocks_per_tile(d: int, g: int, block_q: int) -> int:
    """q-blocks in one block's query tile: as many as fill the block's rows
    at ``g`` query heads per KV head (2 at llama3-8b's G 4, block_q 16)."""
    return max(1, block_rows(d) // (block_q * g))


def smem_bytes(d: int, form: Optional[str]) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: q
    [rows, D+8] and two stages of K and V [64, D+8] in bf16, two stages of
    64 key and value scales, and for a quantized cache the byte stage of
    one K and V tile (64 rows of D bytes each for int8, 32 for int4)."""
    p = d + _PAD
    raw = 2 * block_rows(d) * p + 2 * 2 * 2 * _BK * p + 2 * 2 * _BK * 4
    if form is None:
        return raw
    return raw + 2 * (_BK // 2 if form == "int4" else _BK) * d


def launch_grid(nqb: int, h: int, kh: int, d: int,
                block_q: int) -> Tuple[int, int, int]:
    """The kernel's grid: (q-block, KV head, row chunk of a query tile)."""
    rows = q_blocks_per_tile(d, h // kh, block_q) * block_q * (h // kh)
    return nqb, kh, -(-rows // block_rows(d))


def query_tiles(qoff_of: Sequence[int], base_of: Sequence[int], block_q: int,
                qpt: int) -> List[Tuple[int, int]]:
    """``[(first q-block, q-block count)]`` of the launch's query tiles,
    by the kernel's rule: the q-block whose ``qoff / block_q`` is a multiple
    of ``qpt`` runs a tile of itself and the following q-blocks of the same
    row (same base), at most ``qpt``; every other block returns at once."""
    tiles = []
    nqb = len(base_of)
    for j in range(nqb):
        if (int(qoff_of[j]) // block_q) % qpt:
            continue
        n = 1
        while n < qpt and j + n < nqb and base_of[j + n] == base_of[j]:
            n += 1
        tiles.append((j, n))
    return tiles


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


def _rope_rows(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               dtype=None) -> torch.Tensor:
    """ops/rope.apply_rope's expression on rows ``x [N, heads, D]`` with
    table rows ``sin/cos [N, D/2]``, rounded to ``dtype`` (default: x's)."""
    s = sin[:, None, :]
    c = cos[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype if dtype is None else dtype)


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
    layer_idx, *, k_scale=None, v_scale=None, kv_quant=None,
    block_q: int = RAGGED_BLOCK_Q, rope_theta: float,
    scale: Optional[float] = None, softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version (same function, same layouts):
    per row, rope q and the tail K from the shared table, write the tail
    K/V (quantized, for a quantized cache) into ``cache[layer, slot,
    start:start+n]`` IN PLACE, and run ``history_attention`` over the cache
    row (dequantized and rounded through q's dtype).  Pad tokens of a row's
    last block are part of its tail (causally after every real token)."""
    form = _form(k_scale, v_scale, kv_quant)
    tot, _, d = q.shape
    s = k_cache.shape[2] * (2 if form == "int4" else 1)
    layer = int(layer_idx)
    sin, cos = rope_tables(s, d, rope_theta, q.device)
    slots, starts, bases = (x.tolist() for x in (slot_of, start_of, base_of))
    out = torch.empty_like(q)
    for first, nblk in _rows_of(bases):
        t0, n = first * block_q, nblk * block_q
        st, sl = int(starts[first]), int(slots[first])
        pos = torch.arange(st, st + n, device=q.device)
        qr = _rope_rows(q[t0:t0 + n], sin[pos], cos[pos])
        if form is None:
            k_cache[layer, sl, st:st + n] = _rope_rows(k_new[t0:t0 + n], sin[pos], cos[pos])
            v_cache[layer, sl, st:st + n] = v_new[t0:t0 + n]
            k_row, v_row = k_cache[layer, sl], v_cache[layer, sl]
        else:
            qmax = 7.0 if form == "int4" else 127.0
            kr = _rope_rows(k_new[t0:t0 + n], sin[pos], cos[pos], torch.float32)
            for plane, scales, x in ((k_cache, k_scale, kr),
                                     (v_cache, v_scale, v_new[t0:t0 + n].float())):
                vals, sc = quantize_sym(x, qmax)
                scales[layer, sl, st:st + n] = sc[..., 0]
                if form == "int4":
                    plane[layer, sl, st // 2:(st + n) // 2] = pack_int4(vals, axis=0)
                else:
                    plane[layer, sl, st:st + n] = vals.to(torch.int8)
            k_row = dequant_f32(k_cache[layer, sl][None], k_scale[layer, sl][None],
                                form)[0].to(q.dtype)
            v_row = dequant_f32(v_cache[layer, sl][None], v_scale[layer, sl][None],
                                form)[0].to(q.dtype)
        out[t0:t0 + n] = history_attention(
            qr[None], k_row[None], v_row[None],
            torch.tensor([st], device=q.device),
            scale=scale, softcap=softcap, window=window,
        )[0]
    return out


#: The kernel's plain PyTorch version.
plain = ragged_prefill_plain


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.ragged_prefill_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check_geometry(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                    descs, block_q, form) -> None:
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
    if form == "int4" and block_q % INT4_PACK_TOKENS:
        raise ValueError(
            f"packed int4 ragged prefill needs an even block_q, got "
            f"{block_q} (two tokens share a byte)")
    s = k_cache.shape[2] * (2 if form == "int4" else 1)
    if s % block_q:
        raise ValueError(
            f"max_seq {s} is not a multiple of block_q "
            f"{block_q}: the cache-append blocks would overrun the cache")
    if form is not None:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(x.shape) != tuple(k_cache.shape[:2]) + (s, k_cache.shape[3]):
                raise ValueError(f"{name} must be an [L,B,S,K] plane, got {tuple(x.shape)}")
    nqb = tot // block_q
    for x in descs:
        if tuple(x.shape) != (nqb,):
            raise ValueError(f"descriptor arrays must be [{nqb}] (one per q-block)")
    start_of = descs[1]
    if start_of.device.type == "cpu" and bool((start_of % block_q != 0).any()):
        raise ValueError(f"ragged prefill starts must be multiples of block_q {block_q}")


def _check_kernel(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                  descs, form) -> None:
    d = q.shape[2]
    if d not in _SUPPORTED_D:
        raise ValueError(f"ragged_prefill_attention kernel supports head_dim {_SUPPORTED_D}, got {d}")
    cache_dtype = torch.bfloat16 if form is None else torch.int8
    tensors = [("q", q, torch.bfloat16), ("k_new", k_new, torch.bfloat16),
               ("v_new", v_new, torch.bfloat16), ("k_cache", k_cache, cache_dtype),
               ("v_cache", v_cache, cache_dtype)]
    if form is not None:
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    for name, x, dtype in tensors:
        if x.dtype != dtype:
            raise TypeError(f"ragged_prefill_attention kernel takes {dtype} {name}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"ragged_prefill_attention kernel needs a contiguous, 16-byte aligned {name}")
    for x in descs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("descriptor arrays must be contiguous int32 tensors")
    if smem_bytes(d, form) > kernel_build.MAX_SMEM_BYTES:
        raise ValueError(f"ragged_prefill_attention kernel needs {smem_bytes(d, form)} "
                         f"bytes of shared memory at head_dim {d}")
    devices = {x.device for _, x, _ in tensors} | {x.device for x in descs}
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
    k_scale: Optional[torch.Tensor] = None,  # [L, B, S, K] f32 (quantized)
    v_scale: Optional[torch.Tensor] = None,
    kv_quant: Optional[str] = None,  # None | "int8" | "int4"
    block_q: int = RAGGED_BLOCK_Q,
    rope_theta: float,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged grouped prefill over one layer -> attention ``[TOT, H, D]``;
    the cache's ``[layer]`` plane gets each q-block's roped K and V rows
    (quantized, with their scales, for a quantized cache) appended in
    place.  ``window`` is a per-layer Python int (None = no window)."""
    descs = (slot_of, start_of, qoff_of, base_of)
    form = _form(k_scale, v_scale, kv_quant)
    _check_geometry(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                    descs, block_q, form)
    if q.device.type == "cpu":
        return plain(q, k_new, v_new, k_cache, v_cache, *descs, layer_idx,
                     k_scale=k_scale, v_scale=v_scale, kv_quant=form,
                     block_q=block_q, rope_theta=rope_theta, scale=scale,
                     softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_prefill_attention runs on cuda or cpu, not {q.device}")
    _check_kernel(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, descs, form)
    tot, h, d = q.shape
    n_layers, b, _, kh, _ = k_cache.shape
    s = k_cache.shape[2] * (2 if form == "int4" else 1)
    layer = int(layer_idx)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the cache's {n_layers} layers")
    if scale is None:
        scale = d**-0.5
    sin, cos = rope_tables(s, d, rope_theta, q.device)
    quantized = form is not None
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ragged_prefill_attention_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, sin.data_ptr(),
            cos.data_ptr(), slot_of.data_ptr(), start_of.data_ptr(),
            qoff_of.data_ptr(), base_of.data_ptr(), out.data_ptr(),
            tot // block_q, h, kh, d, block_q, b, s, layer, KV_FORMS[form],
            float(scale), 0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    ragged_prefill_attention.launches += 1
    ragged_prefill_attention.form_launches[form or "none"] += 1
    return out


#: Kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the engine and reads them after): the total, and
#: per cache form.
ragged_prefill_attention.launches = 0
ragged_prefill_attention.form_launches = {"none": 0, "int8": 0, "int4": 0}
