"""The fused decode layer: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py ``fused_decode_layer``.

One launch per layer does what the unfused decode step spreads over many:
rope of q and of the new key row at each slot's position, quantization of
the new K/V row to the cache's form (raw, int8, packed int4), its append
into the ``[L, B, S(/2), K, D]`` cache IN PLACE (for int4 a read-modify-
write of the byte shared with the neighbouring token), and attention over
the cache's ``[0, pos)`` keys plus the new row's own term.

The kernel is ``csrc/fused_decode_layer.cu`` (CUDA C++, sm_90a, built at
first use and loaded with ctypes — see ``ops/kernel_build.py``): the
split-KV body of the fused verify layer (``csrc/split_kv_layer.cuh``,
kernel 5) at one new row per slot, under its own kernel name.  The launch
geometry both kernels share lives here: the splits of the committed keys
(:func:`kv_splits`), the block's shared memory (:func:`smem_bytes`), the
head geometries with an instance (:func:`fits`) and the per-(slot, head)
arrival counters of the in-launch merge.  Its plain version is
:func:`fused_decode_plain`.  The wrapper runs that for tensors on the CPU,
and only because they lie on the CPU; for CUDA tensors it launches the
kernel or raises.  On the card the kernel matches its plain version within
a tolerance (it rounds q and P to bf16 for its tensor-core products and
sums in another order), its appended bytes and scales bit for bit.

The plain version is NOT the unfused decode step: it keeps the kernel's
own rounding points, those of the Pallas body —
- q and the new key are roped in f32 (never rounded to the activation
  dtype) and q is multiplied by the softmax scale in f32;
- the new row is quantized from the f32 roped values;
- cache keys are masked strictly below ``pos`` (the row at ``pos`` is this
  call's own append);
- the new row's term is folded last, from its dequantized f32 values (raw
  caches: the unrounded f32 row, though the cache stores it in bf16).
Both read RoPE from one :func:`rope_rows` table.  Rows at ``pos >=
min(kv_view, S)`` are parked: their cache row and scales stay bit for bit,
their output is junk the engine discards.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from p2p_llm_tunnel_tpu_torch.models.quant import quantize_sym
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import _NEG_INF
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import (
    KV_FORMS,
    _NO_WINDOW,
    _SUPPORTED_D,
    _form,
    dequant_f32,
)
from p2p_llm_tunnel_tpu_torch.ops.rope import rope_table
from p2p_llm_tunnel_tpu_torch.utils.launch_count import kernel_entry

_NAME = "fused_decode_layer"
_QMAX = {"int8": 127.0, "int4": 7.0}
#: Query rows of one (slot, KV head) the split-KV body holds: T * G <= 72
#: (kernel 5's spec_k_max 8 at G = 8; kernel 4, T = 1, up to G = 72).
MAX_ROWS = 72
MAX_SMEM_BYTES = kernel_build.MAX_SMEM_BYTES
_BS = 64  # keys per tile (csrc/split_kv_layer.cuh)
_PAD = 8  # bf16 row padding of q and the K/V tiles
#: Blocks a launch aims for: four per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 4 * 132
#: Splits per (slot, head) at most: bounds the partials' workspace.
MAX_SPLITS = 32


def kv_splits(view: int, b: int, kh: int) -> Tuple[int, int]:
    """``(nsplit, keys_per_split)`` of one split-KV launch (kernels 4 and
    5): the committed keys ``[0, view)`` cut into ``nsplit`` runs of
    ``keys_per_split`` keys, a whole number of 64-key tiles each (the last
    run may reach past ``view``), so that ``b * kh * nsplit`` blocks come
    near four per SM."""
    tiles = max(1, -(-int(view) // _BS))
    want = -(-_TARGET_BLOCKS // max(1, b * kh))
    per = -(-tiles // max(1, min(want, tiles, MAX_SPLITS)))
    return -(-tiles // per), per * _BS


def _key_slices(mt: int) -> int:
    """Warps that share a 64-key tile by key slices, per 16-row tile."""
    return 4 if mt == 1 else (2 if mt == 2 else 1)


def smem_bytes(d: int, t: int, g: int) -> int:
    """Dynamic shared memory of one split-KV block, as the body lays it
    out: the attention phase (q [RP, D+8] bf16, RP = T*G padded to 16, and
    two stages of bf16 K and V tiles [64, D+8]) or the merge phase (the new
    rows' five [T, D] f32 planes and two scales per token), the larger."""
    rp = -(-t * g // 16) * 16
    attn = 2 * rp * (d + _PAD) + 2 * 2 * 2 * _BS * (d + _PAD)
    merge = 4 * (5 * t * d + 2 * t)
    return max(attn, merge)


def fits(d: int, t: int, g: int) -> Optional[str]:
    """None when the split-KV body has an instance for ``t`` new rows per
    slot (kernel 4: 1; kernel 5: the verify burst) of ``g`` query heads per
    KV head at head dim ``d``, else why not (the engine fences the fused
    decode layer on it)."""
    if d not in _SUPPORTED_D:
        return f"head_dim {d} is not one of {_SUPPORTED_D}"
    if t * g > MAX_ROWS:
        return (f"{t} new rows x {g} query heads per KV head is {t * g} query "
                f"rows per block, above the kernel's {MAX_ROWS}")
    if smem_bytes(d, t, g) > MAX_SMEM_BYTES:
        return (f"{smem_bytes(d, t, g)} bytes of shared memory per block "
                f"(head_dim {d}, {t} x {g} rows) exceed the card's {MAX_SMEM_BYTES}")
    return None


def fence_reason(d: int, g: int, burst: int = 0) -> Optional[str]:
    """Why the engine fences the fused decode layer on the card for head
    dim ``d`` and ``g`` query heads per KV head — kernel 4 (one new row
    per slot) has no instance, or with speculation kernel 5 has none for
    the widest verify burst of ``burst`` rows — else None."""
    why = fits(d, 1, g)
    if why is not None:
        return f"the fused decode kernel has no instance: {why}"
    if burst > 0:
        why = fits(d, burst, g)
        if why is not None:
            return f"the fused verify kernel has no instance: {why}"
    return None


#: Per-(slot, head) arrival counters, int32 [B*K] per (device, B, K), shared
#: by kernels 4 and 5: zeroed once; the last block of each (slot, head) of
#: a launch leaves its counter 0, so the next launch on the same stream —
#: which starts only after this one ends — finds every counter at 0.  The
#: engine issues every layer's launch on one stream.
_ARRIVALS: dict = {}


def split_kv_workspace(device: torch.device, b: int, kh: int, t: int, g: int,
                       d: int, view: int):
    """``(nsplit, split_keys, part_acc, part_ml, arrivals)`` of one
    split-KV launch: the splits, the partials' f32 workspace (from the
    allocator, no memset: every partial the merge reads is written first)
    and the arrival counters."""
    nsplit, split_keys = kv_splits(view, b, kh)
    rows = t * g
    parts = b * kh * nsplit * _key_slices(-(-rows // 16)) * rows
    part_acc = torch.empty(parts * d, dtype=torch.float32, device=device)
    part_ml = torch.empty(parts * 2, dtype=torch.float32, device=device)
    key = (device, b, kh)
    arrivals = _ARRIVALS.get(key)
    if arrivals is None:
        arrivals = _ARRIVALS[key] = torch.zeros(b * kh, dtype=torch.int32,
                                                device=device)
    return nsplit, split_keys, part_acc, part_ml, arrivals


def rope_rows(positions: torch.Tensor, d: int,
              theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) ``[B, D/2]`` f32 at each slot's position, from
    ``ops/rope.rope_table`` — the one table kernel and plain version read.
    ``decode_step`` builds it once per step and hands it to every layer."""
    sin, cos = rope_table(positions, d, theta)
    return sin.contiguous(), cos.contiguous()


def _rope_f32(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope of ``x [..., heads, D]`` in f32 (no final rounding)
    from ``sin``/``cos`` ``[..., D/2]``: x1*cos - x2*sin, x2*cos + x1*sin,
    each product and sum rounded once."""
    s = sin[..., None, :]
    c = cos[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class NewRows(NamedTuple):
    """The new rows of one call, as the kernels hold them (f32)."""

    q: torch.Tensor  # roped, pre-scaled queries
    k: torch.Tensor  # roped key (unrounded)
    kq: Optional[torch.Tensor]  # quantized values (quantized forms)
    vq: Optional[torch.Tensor]
    ks: Optional[torch.Tensor]  # per-(token, head) scales
    vs: Optional[torch.Tensor]
    kd: torch.Tensor  # the key and value the new row's own term attends
    vd: torch.Tensor


def new_rows(q, k_new, v_new, sin, cos, scale: float,
             form: Optional[str]) -> NewRows:
    """Rope of q and the new key in f32, q pre-scaled, and the new row
    quantized from the unrounded f32 values (any leading shape)."""
    qr = _rope_f32(q, sin, cos) * scale
    kr = _rope_f32(k_new, sin, cos)
    vr = v_new.to(torch.float32)
    if form is None:
        return NewRows(qr, kr, None, None, None, None, kr, vr)
    kq, ks = quantize_sym(kr, _QMAX[form])
    vq, vs = quantize_sym(vr, _QMAX[form])
    return NewRows(qr, kr, kq, vq, ks[..., 0], vs[..., 0], kq * ks, vq * vs)


def cache_f32(k_cache, v_cache, k_scale, v_scale, layer: int, view: int,
              form: Optional[str]):
    """One layer's cache view ``[B, view, K, D]`` as f32 (dequantized)."""
    rows = view // 2 if form == "int4" else view
    kc, vc = k_cache[layer, :, :rows], v_cache[layer, :, :rows]
    if form is None:
        return kc.to(torch.float32), vc.to(torch.float32)
    return (dequant_f32(kc, k_scale[layer, :, :view], form),
            dequant_f32(vc, v_scale[layer, :, :view], form))


def attend(q5, kc, vc, kd, vd, positions, view: int, win: int,
           softcap: Optional[float]) -> torch.Tensor:
    """The kernels' attention for one query position per slot: ``q5 [B, K,
    G, D]`` (pre-scaled) over the cache view's keys strictly below
    ``positions`` (within the window), then the new row ``kd``/``vd [B, K,
    D]`` folded last -> ``[B, K, G, D]`` f32."""
    sc = torch.einsum("bkgd,bskd->bkgs", q5, kc)
    new = torch.einsum("bkgd,bkd->bkg", q5, kd)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
        new = softcap * torch.tanh(new / softcap)
    pos = positions.to(torch.int64)[:, None]
    j = torch.arange(view, device=q5.device)[None, :]
    mask = (j < pos) & ((pos - j) < win)
    sc = torch.where(mask[:, None, None, :], sc, _NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.where(sc == _NEG_INF, 0.0, torch.exp(sc - m[..., None]))
    acc = torch.einsum("bkgs,bskd->bkgd", p, vc)
    l_c = p.sum(dim=-1)
    # The new row's term, folded last (the kernel's emit step).
    m_new = torch.maximum(m, new)
    corr = torch.where(m == _NEG_INF, 0.0, torch.exp(m - m_new))
    p_new = torch.exp(new - m_new)
    acc = acc * corr[..., None] + p_new[..., None] * vd[:, :, None, :]
    l_new = l_c * corr + p_new
    return acc / l_new.clamp(min=1e-30)[..., None]


def append_rows(k_cache, v_cache, k_scale, v_scale, layer: int,
                form: Optional[str], positions, view: int, k_row, v_row,
                rows: NewRows) -> None:
    """Store one new row per slot at ``positions`` IN PLACE (``rows``:
    that token's ``NewRows``, ``[B, K, D]`` leaves; raw caches store the
    roped key ``k_row`` and ``v_row`` in the cache dtype); parked rows
    (``pos >= view``) keep their row and scales."""
    b = positions.shape[0]
    live = positions.to(torch.int64) < view
    slots = torch.arange(b, device=positions.device)[live]
    at = positions.to(torch.int64)[live]
    if form is None:
        k_cache[layer, slots, at] = k_row[live].to(k_cache.dtype)
        v_cache[layer, slots, at] = v_row[live].to(v_cache.dtype)
        return
    for plane, vals in ((k_cache, rows.kq), (v_cache, rows.vq)):
        vals = vals[live].to(torch.int8)
        if form == "int8":
            plane[layer, slots, at] = vals
            continue
        old = plane[layer, slots, at // 2].to(torch.int16)
        even = (at % 2 == 0)[:, None, None]
        new_b = vals.to(torch.int16)
        merged = torch.where(even, (old & 0xF0) | (new_b & 0x0F),
                             (new_b * 16) | (old & 0x0F)) & 0xFF
        plane[layer, slots, at // 2] = merged.to(torch.uint8).view(torch.int8)
    k_scale[layer, slots, at] = rows.ks[live]
    v_scale[layer, slots, at] = rows.vs[live]


def fused_decode_plain(
    q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
    layer_idx, *, kv_view: int, rope_theta: float,
    kv_quant: Optional[str] = None, scale: Optional[float] = None,
    softcap: Optional[float] = None, window: Optional[int] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version (same function, same layouts,
    same rounding points; see the module docstring).  Updates the cache
    IN PLACE and returns attention ``[B, H, D]``."""
    form = _form(k_scale, v_scale, kv_quant)
    b, h, d = q.shape
    kh = k_new.shape[1]
    layer = int(layer_idx)
    view = min(int(kv_view), k_cache.shape[2] * (2 if form == "int4" else 1))
    if scale is None:
        scale = d**-0.5
    win = _NO_WINDOW if window is None else int(window)
    sin, cos = rope if rope is not None else rope_rows(positions, d, rope_theta)
    rows = new_rows(q, k_new, v_new, sin, cos, scale, form)
    kc, vc = cache_f32(k_cache, v_cache, k_scale, v_scale, layer, view, form)
    out = attend(rows.q.reshape(b, kh, h // kh, d), kc, vc, rows.kd, rows.vd,
                 positions, view, win, softcap)
    append_rows(k_cache, v_cache, k_scale, v_scale, layer, form, positions,
                view, rows.k, v_new, rows)
    return out.reshape(b, h, d).to(q.dtype)


#: The kernel's plain PyTorch version.
plain = fused_decode_plain


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.fused_decode_layer_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
           form, layer) -> None:
    if q.dim() != 3 or k_new.dim() != 3 or k_new.shape != v_new.shape:
        raise ValueError("fused_decode_layer takes q [B,H,D], k/v_new [B,K,D]")
    b, h, d = q.shape
    kh = k_new.shape[1]
    if k_new.shape[0] != b or k_new.shape[2] != d or h % kh:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not match q {tuple(q.shape)}")
    why = fits(d, 1, h // kh)
    if why is not None:
        raise ValueError(f"fused_decode_layer kernel: {why}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v cache must be matching [L,B,S,K,D] tensors")
    if k_cache.shape[1] != b or tuple(k_cache.shape[3:]) != (kh, d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match k_new {tuple(k_new.shape)}")
    if not 0 <= layer < k_cache.shape[0]:
        raise ValueError(f"layer {layer} outside the cache's {k_cache.shape[0]} layers")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"fused_decode_layer kernel takes bfloat16 {name}, got {x.dtype}")
    cache_dtype = torch.bfloat16 if form is None else torch.int8
    tensors = [q, k_new, v_new, k_cache, v_cache, positions]
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != cache_dtype:
            raise TypeError(f"fused_decode_layer kernel takes {cache_dtype} {name} "
                            f"for kv_quant={form}, got {x.dtype}")
    if form is not None:
        s = k_cache.shape[2] * (2 if form == "int4" else 1)
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != tuple(k_cache.shape[:2]) + (s, kh):
                raise ValueError(f"{name} must be a float32 [L,B,S,K] plane")
        tensors += [k_scale, v_scale]
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError("fused_decode_layer kernel needs contiguous, 4-byte aligned tensors")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("fused_decode_layer kernel copies cache rows 16 bytes "
                         "at a time: the caches must be 16-byte aligned")
    if (positions.dtype != torch.int32 or tuple(positions.shape) != (b,)
            or not positions.is_contiguous()):
        raise ValueError("positions must be a contiguous [B] int32 tensor")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_decode_layer inputs span devices {devices}")


@kernel_entry
def fused_decode_layer(
    q: torch.Tensor,  # [B, H, D] post-projection, PRE-rope
    k_new: torch.Tensor,  # [B, K, D] post-projection, PRE-rope
    v_new: torch.Tensor,  # [B, K, D]
    k_cache: torch.Tensor,  # [L, B, S, K, D] raw/int8 | [L, B, S/2, K, D] int4
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [L, B, S, K] f32, or None
    v_scale: Optional[torch.Tensor],
    positions: torch.Tensor,  # [B] int32
    layer_idx: int,
    *,
    kv_view: int,
    rope_theta: float,
    kv_quant: Optional[str] = None,  # None | "int8" | "int4"
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One layer's decode attention sub-block -> attention ``[B, H, D]``;
    the cache (and its scales) gets each live slot's new row IN PLACE.
    ``window`` is a per-layer Python int (None = no window); ``rope`` is
    the step's :func:`rope_rows` table (built here when not given)."""
    form = _form(k_scale, v_scale, kv_quant)
    if q.device.type == "cpu":
        return plain(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                     positions, layer_idx, kv_view=kv_view,
                     rope_theta=rope_theta, kv_quant=form, scale=scale,
                     softcap=softcap, window=window, rope=rope)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_layer runs on cuda or cpu, not {q.device}")
    layer = int(layer_idx)
    _check(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
           form, layer)
    b, h, d = q.shape
    n_layers, _, _, kh, _ = k_cache.shape
    s = k_cache.shape[2] * (2 if form == "int4" else 1)
    view = min(int(kv_view), s)
    if scale is None:
        scale = d**-0.5
    sin, cos = rope if rope is not None else rope_rows(positions, d, rope_theta)
    for name, x in (("sin", sin), ("cos", cos)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, d // 2)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"rope {name} must be a contiguous float32 [B,D/2] "
                             f"table on {q.device}")
    quantized = form is not None
    lib = _lib()
    out = torch.empty_like(q)
    nsplit, split_keys, part_acc, part_ml, arrivals = split_kv_workspace(
        q.device, b, kh, 1, h // kh, d, view)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_decode_layer_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            sin.data_ptr(), cos.data_ptr(), positions.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            arrivals.data_ptr(), b, s, h, kh, d, n_layers, layer, view,
            KV_FORMS[form], nsplit, split_keys, float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    fused_decode_layer.launches += 1
    fused_decode_layer.form_launches[form or "none"] += 1
    return out


#: Kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the engine and reads them after): the total, and
#: per cache form.
fused_decode_layer.launches = 0
fused_decode_layer.form_launches = {"none": 0, "int8": 0, "int4": 0}
