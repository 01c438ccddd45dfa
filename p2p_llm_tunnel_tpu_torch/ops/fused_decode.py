"""The fused decode layer: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py ``fused_decode_layer``.

One launch per layer does what the unfused decode step spreads over many:
rope of q and of the new key row at each slot's position, quantization of
the new K/V row to the cache's form (raw, int8, packed int4), its append
into the ``[L, B, S(/2), K, D]`` cache IN PLACE (for int4 a read-modify-
write of the byte shared with the neighbouring token), and attention over
the cache's ``[0, pos)`` keys plus the new row's own term.

The kernel is ``csrc/fused_decode_layer.cu`` (CUDA C++, sm_90a, built at
first use and loaded with ctypes — see ``ops/kernel_build.py``).  Its plain
version is :func:`fused_decode_plain`.  The wrapper runs that for tensors
on the CPU, and only because they lie on the CPU; for CUDA tensors it
launches the kernel or raises.

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
    _MAX_GROUP,
    _NO_WINDOW,
    _SUPPORTED_D,
    _form,
    dequant_f32,
)
from p2p_llm_tunnel_tpu_torch.ops.rope import rope_table

_NAME = "fused_decode_layer"
_QMAX = {"int8": 127.0, "int4": 7.0}


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
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
           form, layer) -> None:
    if q.dim() != 3 or k_new.dim() != 3 or k_new.shape != v_new.shape:
        raise ValueError("fused_decode_layer takes q [B,H,D], k/v_new [B,K,D]")
    b, h, d = q.shape
    kh = k_new.shape[1]
    if k_new.shape[0] != b or k_new.shape[2] != d or h % kh or h // kh > _MAX_GROUP:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not match q {tuple(q.shape)} "
                         f"(H/K <= {_MAX_GROUP})")
    if d not in _SUPPORTED_D:
        raise ValueError(f"fused_decode_layer kernel supports head_dim {_SUPPORTED_D}, got {d}")
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
    if (positions.dtype != torch.int32 or tuple(positions.shape) != (b,)
            or not positions.is_contiguous()):
        raise ValueError("positions must be a contiguous [B] int32 tensor")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_decode_layer inputs span devices {devices}")


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
    quantized = form is not None
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_decode_layer_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            sin.data_ptr(), cos.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, s, h, kh, d, n_layers, layer, view,
            KV_FORMS[form], float(scale),
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
