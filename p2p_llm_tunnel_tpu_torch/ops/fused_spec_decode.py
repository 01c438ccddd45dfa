"""The fused K-token speculative verify layer: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py ``fused_spec_decode_layer``.

Kernel 4 (``ops/fused_decode``) for T = K + 1 new rows per slot in one
launch per layer: rope of the T query rows and new keys at positions ``pos
+ t``, quantization of the T new K/V rows to the cache's form, their T
appends IN PLACE, and for each row ``t`` attention over the cache's keys
below ``pos + t`` — the burst's earlier rows ``t' < t`` substituted at
their positions, as the cache will hold them — with row ``t``'s own term
folded last.  Rows with ``pos + t >= min(kv_view, S)`` are parked per
token: nothing is stored, their output is junk.

The kernel is ``csrc/fused_spec_decode_layer.cu`` (CUDA C++, sm_90a, built
at first use and loaded with ctypes — see ``ops/kernel_build.py``), the
split-KV body ``csrc/split_kv_layer.cuh`` that kernel 4 runs at one row
per slot: split over the committed keys (:func:`spec_splits`), tensor-core
products over the burst's T·G rows, and the splits merged inside the same
launch by the last block to arrive.  The launch geometry and the arrival
counters are kernel 4's (``ops/fused_decode``), re-exported here under
the names kernel 5's callers use.  Its plain version is :func:`fused_spec_decode_plain`,
with kernel 4's rounding points (``ops/fused_decode``): the substituted
earlier rows are the values the cache stores (raw: rounded to the cache
dtype; quantized: dequantized), a row's own term uses the unrounded f32
(raw) or dequantized values.  On the CPU the plain version is bitwise T
sequential plain kernel-4 calls, which keeps greedy streams identical with
speculation on and off there.  On the card the kernel sums in another
order and rounds q and P to bf16 for its products: it matches its plain
version and T kernel-4 launches within a tolerance, its appended bytes and
scales bit for bit.  The wrapper runs the plain version for tensors on the
CPU, and only because they lie on the CPU; for CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import KV_FORMS, _NO_WINDOW, _form
from p2p_llm_tunnel_tpu_torch.ops.fused_decode import (  # noqa: F401  (re-exports)
    MAX_SMEM_BYTES,
    MAX_SPLITS,
    append_rows,
    attend,
    cache_f32,
    fits,
    kv_splits as spec_splits,
    new_rows,
    rope_rows,
    smem_bytes,
    split_kv_workspace,
)

_NAME = "fused_spec_decode_layer"


def burst_rope_rows(positions: torch.Tensor, t: int, d: int,
                    theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) ``[B, T, D/2]`` f32 at positions ``pos + t``: the one
    table kernel and plain version read, built once per verify burst."""
    at = positions.to(torch.int64)[:, None] + torch.arange(
        t, device=positions.device)[None, :]
    return rope_rows(at, d, theta)


def fused_spec_decode_plain(
    q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
    layer_idx, *, kv_view: int, rope_theta: float,
    kv_quant: Optional[str] = None, scale: Optional[float] = None,
    softcap: Optional[float] = None, window: Optional[int] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version (same function, same layouts,
    same rounding points; see the module docstring).  Updates the cache
    IN PLACE and returns attention ``[B, T, H, D]``."""
    form = _form(k_scale, v_scale, kv_quant)
    b, t, h, d = q.shape
    kh = k_new.shape[2]
    layer = int(layer_idx)
    view = min(int(kv_view), k_cache.shape[2] * (2 if form == "int4" else 1))
    if scale is None:
        scale = d**-0.5
    win = _NO_WINDOW if window is None else int(window)
    sin, cos = (rope if rope is not None
                else burst_rope_rows(positions, t, d, rope_theta))
    rows = new_rows(q, k_new, v_new, sin, cos, scale, form)
    # The burst's rows as a later read of the cache sees them.
    if form is None:
        k_sub = rows.k.to(k_cache.dtype).to(torch.float32)
        v_sub = v_new.to(v_cache.dtype).to(torch.float32)
    else:
        k_sub, v_sub = rows.kd, rows.vd
    kc, vc = cache_f32(k_cache, v_cache, k_scale, v_scale, layer, view, form)
    kc, vc = kc.clone(), vc.clone()  # substituted below, never the cache
    pos = positions.to(torch.int64)
    slots = torch.arange(b, device=q.device)
    out = []
    for i in range(t):
        if i:
            p = pos + i - 1
            at = p.clamp(max=view - 1)
            live = (p < view)[:, None, None]
            kc[slots, at] = torch.where(live, k_sub[:, i - 1], kc[slots, at])
            vc[slots, at] = torch.where(live, v_sub[:, i - 1], vc[slots, at])
        out.append(attend(rows.q[:, i].reshape(b, kh, h // kh, d), kc, vc,
                          rows.kd[:, i].contiguous(), rows.vd[:, i].contiguous(),
                          pos + i, view, win, softcap))
    for i in range(t):
        tok = type(rows)(*(None if x is None else x[:, i] for x in rows))
        append_rows(k_cache, v_cache, k_scale, v_scale, layer, form,
                    positions + i, view, rows.k[:, i], v_new[:, i], tok)
    return torch.stack(out, dim=1).reshape(b, t, h, d).to(q.dtype)


#: The kernel's plain PyTorch version.
plain = fused_spec_decode_plain


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.fused_spec_decode_layer_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
           sin, cos, form, layer) -> None:
    if q.dim() != 4 or k_new.dim() != 4 or k_new.shape != v_new.shape:
        raise ValueError("fused_spec_decode_layer takes q [B,T,H,D], "
                         "k/v_new [B,T,K,D]")
    b, t, h, d = q.shape
    kh = k_new.shape[2]
    if tuple(k_new.shape[:2]) != (b, t) or k_new.shape[3] != d or h % kh:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not match q {tuple(q.shape)}")
    why = fits(d, t, h // kh)
    if why is not None:
        raise ValueError(f"fused_spec_decode_layer kernel: {why}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v cache must be matching [L,B,S,K,D] tensors")
    if k_cache.shape[1] != b or tuple(k_cache.shape[3:]) != (kh, d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match k_new {tuple(k_new.shape)}")
    if not 0 <= layer < k_cache.shape[0]:
        raise ValueError(f"layer {layer} outside the cache's {k_cache.shape[0]} layers")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"fused_spec_decode_layer kernel takes bfloat16 {name}, got {x.dtype}")
    cache_dtype = torch.bfloat16 if form is None else torch.int8
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != cache_dtype:
            raise TypeError(f"fused_spec_decode_layer kernel takes {cache_dtype} "
                            f"{name} for kv_quant={form}, got {x.dtype}")
    tensors = [q, k_new, v_new, k_cache, v_cache, positions, sin, cos]
    if form is not None:
        s = k_cache.shape[2] * (2 if form == "int4" else 1)
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != tuple(k_cache.shape[:2]) + (s, kh):
                raise ValueError(f"{name} must be a float32 [L,B,S,K] plane")
        tensors += [k_scale, v_scale]
    for name, x in (("sin", sin), ("cos", cos)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, t, d // 2):
            raise ValueError(f"rope {name} must be a float32 [B,T,D/2] table")
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError("fused_spec_decode_layer kernel needs contiguous, "
                             "4-byte aligned tensors")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("fused_spec_decode_layer kernel copies cache rows 16 "
                         "bytes at a time: the caches must be 16-byte aligned")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (b,):
        raise ValueError("positions must be a contiguous [B] int32 tensor")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_spec_decode_layer inputs span devices {devices}")


def fused_spec_decode_layer(
    q: torch.Tensor,  # [B, T, H, D] post-projection, PRE-rope
    k_new: torch.Tensor,  # [B, T, K, D] post-projection, PRE-rope
    v_new: torch.Tensor,  # [B, T, K, D]
    k_cache: torch.Tensor,  # [L, B, S, K, D] raw/int8 | [L, B, S/2, K, D] int4
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [L, B, S, K] f32, or None
    v_scale: Optional[torch.Tensor],
    positions: torch.Tensor,  # [B] int32: position of burst row 0
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
    """One layer's verify-burst attention sub-block -> ``[B, T, H, D]``;
    the cache (and its scales) gets each live row ``pos + t`` IN PLACE.
    ``window`` is a per-layer Python int (None = no window); ``rope`` is
    the burst's :func:`burst_rope_rows` table (built here when not
    given)."""
    form = _form(k_scale, v_scale, kv_quant)
    if q.device.type == "cpu":
        return plain(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                     positions, layer_idx, kv_view=kv_view,
                     rope_theta=rope_theta, kv_quant=form, scale=scale,
                     softcap=softcap, window=window, rope=rope)
    if q.device.type != "cuda":
        raise ValueError(f"fused_spec_decode_layer runs on cuda or cpu, not {q.device}")
    layer = int(layer_idx)
    b, t, h, d = q.shape
    sin, cos = (rope if rope is not None
                else burst_rope_rows(positions, t, d, rope_theta))
    _check(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
           sin, cos, form, layer)
    n_layers, _, _, kh, _ = k_cache.shape
    s = k_cache.shape[2] * (2 if form == "int4" else 1)
    view = min(int(kv_view), s)
    if scale is None:
        scale = d**-0.5
    quantized = form is not None
    lib = _lib()
    out = torch.empty_like(q)
    nsplit, split_keys, part_acc, part_ml, arrivals = split_kv_workspace(
        q.device, b, kh, t, h // kh, d, view)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_spec_decode_layer_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            sin.data_ptr(), cos.data_ptr(), positions.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            arrivals.data_ptr(), b, t, s, h, kh, d, n_layers, layer, view,
            KV_FORMS[form], nsplit, split_keys, float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    fused_spec_decode_layer.launches += 1
    fused_spec_decode_layer.form_launches[form or "none"] += 1
    return out


#: Kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the engine and reads them after): the total, and
#: per cache form.
fused_spec_decode_layer.launches = 0
fused_spec_decode_layer.form_launches = {"none": 0, "int8": 0, "int4": 0}
