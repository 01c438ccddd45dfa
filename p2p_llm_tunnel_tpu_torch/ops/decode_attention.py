"""Slot-decode attention: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
``flash_decode_attention_sgrid`` and its ``_int8`` / ``_int4`` entries.

The kernel is ``csrc/flash_decode_attention.cu`` (CUDA C++, sm_90a, built
at first use and loaded with ctypes — see ``ops/kernel_build.py``): the
split-KV body of the fused decode layers (``csrc/split_kv_layer.cuh``) in
its attention-only mode, one block per (KV head, slot, split) and an
in-launch merge in split order, on the launch plan of kernels 4 and 5 at
one row per slot (``ops/fused_decode.split_kv_workspace``).  Its plain
version is :func:`decode_plain`: ``ops/attention.cached_attention`` over
the cache, dequantized in f32 first when it is quantized.  The wrapper
runs that for tensors on the CPU, and only because they lie on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
On the card the kernel matches its plain version within a tolerance (it
rounds P to bf16 for its tensor-core product, feeds a quantized cache's
integers to it with the scales on the scores and on P, and sums in
another order), and two launches on equal inputs are bitwise equal.

The cache arguments may be strided windows of the model's
``[L, B, S_max, K, D]`` cache (``cache[l, :, :view]``): each slot's
``[S, K, D]`` block must be dense, the slot stride is free, so the kernel
reads the view in place with no copy.  Quantized forms, as in the
reference: ``kv_quant="int8"`` reads int8 ``[B, S, K, D]`` planes,
``"int4"`` packed ``[B, S/2, K, D]`` bytes (token 2i in the low nibble of
byte i, 2i+1 in the high), both with f32 ``[B, S, K]`` per-(token, head)
scales (``cache_scale[l, :, :view]``).  The plain version dequantizes in
f32 and does not round to the activation dtype (the Pallas body's rule).

The module also holds kernel 3, :func:`flash_decode_attention_plane`
(``csrc/flash_decode_attention_plane.cu``), the counterpart of the
reference's legacy whole-plane body: raw caches only, kept as a
cross-check of kernel 2 and never called by the model layer.  It shares
nothing with kernel 2's split-KV body: a thread-block cluster per (slot,
KV head) splits the plane along S on its own plan (:func:`plane_plan`)
and merges through distributed shared memory.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from p2p_llm_tunnel_tpu_torch.models.quant import unpack_int4
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import cached_attention
from p2p_llm_tunnel_tpu_torch.utils.launch_count import kernel_entry

_NAME = "flash_decode_attention"
_SUPPORTED_D = (16, 32, 64, 128, 256)  # every preset's head_dim
#: Query heads per KV head the split-KV body holds at one row per slot
#: (``ops/fused_decode.MAX_ROWS``).
_MAX_GROUP = 72
#: ``window=None``: no key is ever too old, parked rows (pos >= S) included.
_NO_WINDOW = 2**31 - 1
#: The cache forms and the kernel's code for each.
KV_FORMS = {None: 0, "int8": 1, "int4": 2}

#: Tokens per byte along the packed int4 sequence axis: bulk writers
#: (chunk segments, pool page copies) must start and end on whole bytes.
INT4_PACK_TOKENS = 2


def page_alignment_violations(kv_quant: Optional[str], page_tokens: int,
                              chunk_tokens: int) -> List[str]:
    """The block-page alignment rule of the packed int4 cache (the
    reference's, verbatim): under ``kv_quant="int4"`` the pool page size
    and the chunk-prefill segment width must both be multiples of
    :data:`INT4_PACK_TOKENS`, so every chunk start and every page copy
    covers whole bytes.  Returns readable violations (empty = aligned); the
    engine turns them into config fences at startup."""
    if kv_quant != "int4":
        return []
    out = []
    if page_tokens % INT4_PACK_TOKENS:
        out.append(
            f"pool page size {page_tokens} is not a multiple of the int4 "
            f"packing ({INT4_PACK_TOKENS} tokens/byte)"
        )
    if chunk_tokens > 0 and chunk_tokens % INT4_PACK_TOKENS:
        out.append(
            f"chunk segment width {chunk_tokens} is not a multiple of the "
            f"int4 packing ({INT4_PACK_TOKENS} tokens/byte)"
        )
    return out


def dequant_f32(vals: torch.Tensor, scale: torch.Tensor,
                kv_quant: Optional[str]) -> torch.Tensor:
    """Quantized cache rows ``[B, S(/2), K, D]`` and scales ``[B, S, K]``
    -> f32 ``[B, S, K, D]`` (unpacked for int4), not rounded further."""
    if kv_quant == "int4":
        vals = unpack_int4(vals, axis=1)
    return vals.to(torch.float32) * scale[..., None]


def decode_plain(q, k_cache, v_cache, positions, *, k_scale=None,
                 v_scale=None, kv_quant=None, scale=None, softcap=None,
                 window=None) -> torch.Tensor:
    """The kernel's plain PyTorch version (same function, same layouts):
    ``cached_attention`` over the cache, dequantized in f32 when quantized."""
    kv_quant = _form(k_scale, v_scale, kv_quant)
    if kv_quant is not None:
        k_cache = dequant_f32(k_cache, k_scale, kv_quant)
        v_cache = dequant_f32(v_cache, v_scale, kv_quant)
    return cached_attention(q, k_cache, v_cache, positions, scale=scale,
                            softcap=softcap, window=window)


#: The kernel's plain PyTorch version.
plain = decode_plain


def _form(k_scale, v_scale, kv_quant) -> Optional[str]:
    """The cache form: scales without a mode mean int8 (the reference's
    convention); a mode needs scales and scales need a mode."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if kv_quant is None and k_scale is not None:
        kv_quant = "int8"
    if kv_quant not in KV_FORMS:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    if (kv_quant is not None) != (k_scale is not None):
        raise ValueError("kv_quant requires k_scale/v_scale and vice versa")
    return kv_quant


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.flash_decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return lib


def _check(q, k_cache, v_cache, k_scale, v_scale, positions, form,
           max_group: int = _MAX_GROUP, kernel: str = "flash_decode_attention") -> int:
    """Validate the kernel's inputs; returns the view's token count S."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_attention takes q [B,1,H,D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v cache must be matching [B,S,K,D] tensors")
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    kh = k_cache.shape[2]
    s = k_cache.shape[1] * (2 if form == "int4" else 1)
    if h % kh or h // kh > max_group:
        raise ValueError(
            f"{kernel} kernel takes H/K <= {max_group} query "
            f"rows per kv head, got {h}/{kh}"
        )
    if d not in _SUPPORTED_D:
        raise ValueError(f"flash_decode_attention kernel supports head_dim {_SUPPORTED_D}, got {d}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_decode_attention kernel takes bfloat16 q, got {q.dtype}")
    cache_dtype = torch.bfloat16 if form is None else torch.int8
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != cache_dtype:
            raise TypeError(f"flash_decode_attention kernel takes {cache_dtype} "
                            f"{name} for kv_quant={form}, got {x.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode_attention kernel needs a contiguous q")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != kh * d:
            raise ValueError(f"{name}: each slot's [S,K,D] block must be dense")
        if x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16:
            raise ValueError(f"{name}: the kernel copies cache rows 16 bytes at "
                             f"a time, so its start and slot stride must be "
                             f"16-byte aligned")
    if k_cache.stride(0) != v_cache.stride(0):
        raise ValueError("k and v caches must share a slot stride")
    tensors = [q, k_cache, v_cache, positions]
    if form is not None:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != (b, s, kh):
                raise ValueError(f"{name} must be a [B,S,K] = {(b, s, kh)} "
                                 f"float32 view, got {tuple(x.shape)} {x.dtype}")
            if x.stride(2) != 1 or x.stride(1) != kh:
                raise ValueError(f"{name}: each slot's [S,K] block must be dense")
        if k_scale.stride(0) != v_scale.stride(0):
            raise ValueError("k and v scales must share a slot stride")
        tensors += [k_scale, v_scale]
    if (positions.dtype != torch.int32 or tuple(positions.shape) != (b,)
            or not positions.is_contiguous()):
        raise ValueError("positions must be a contiguous [B] int32 tensor")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash_decode_attention inputs span devices {devices}")
    return s


@kernel_entry
def flash_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D] bf16 | int8 | [B, S/2, K, D] int4
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [B] int32
    *,
    k_scale: Optional[torch.Tensor] = None,  # [B, S, K] f32 (quantized)
    v_scale: Optional[torch.Tensor] = None,
    kv_quant: Optional[str] = None,  # None | "int8" | "int4"
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query token per slot against its cache -> [B, 1, H, D]; drop-in
    for ``cached_attention`` on a raw cache.  ``window`` is a per-layer
    Python int (None = no window)."""
    form = _form(k_scale, v_scale, kv_quant)
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, positions, k_scale=k_scale,
                     v_scale=v_scale, kv_quant=form, scale=scale,
                     softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention runs on cuda or cpu, not {q.device}")
    s = _check(q, k_cache, v_cache, k_scale, v_scale, positions, form)
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    if scale is None:
        scale = d**-0.5
    # The split-KV plan of kernels 4 and 5 at one row per slot (imported
    # here: that module imports this one).
    from p2p_llm_tunnel_tpu_torch.ops.fused_decode import split_kv_workspace

    lib = _lib()
    out = torch.empty_like(q)
    quantized = form is not None
    nsplit, split_keys, part_acc, part_ml, arrivals = split_kv_workspace(
        q.device, b, kh, 1, h // kh, d, s)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            positions.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), arrivals.data_ptr(), b, s, h, kh, d,
            k_cache.stride(0), k_scale.stride(0) if quantized else 0,
            KV_FORMS[form], nsplit, split_keys, float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    flash_decode_attention.launches += 1
    flash_decode_attention.form_launches[form or "none"] += 1
    return out


#: Kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the engine and reads them after): the total, and
#: per cache form.
flash_decode_attention.launches = 0
flash_decode_attention.form_launches = {"none": 0, "int8": 0, "int4": 0}


# ---------------------------------------------------------------------------
# Kernel 3: the legacy whole-plane decode kernel (a cross-check only)
# ---------------------------------------------------------------------------

_PLANE = "flash_decode_attention_plane"
#: The plane kernel's key block (the Pallas BLOCK_K): S must be a multiple.
PLANE_BLOCK = 128
#: Keys per ring tile of kernel 3 (two per block).
PLANE_TILE = 64
#: Query heads per KV head the plane kernel holds (its MAX_G).
_PLANE_MAX_GROUP = 8
#: Cluster sizes kernel 3 launches with (8 is the portable maximum).
PLANE_CLUSTERS = (1, 2, 4, 8)
#: The plan's aim: two CTAs an SM on the H100's 132 SMs.  Each CTA pays a
#: fixed cost (its barriers, partials and merge) that more CTAs do not
#: hide: at B 17, 8 KV heads, clusters of 2 beat 4 and 8 at views 512-4096
#: (PERF.md §6, PR 18's plan sweep).
_PLANE_TARGET_CTAS = 2 * 132
#: Ring depth (the kernel's MAX_STAGES): two K/V tile pairs keep three CTAs
#: an SM at D 128 (a third stage cost an SM's third CTA and bought nothing
#: in the sweep).
_PLANE_STAGES = 2
#: Shared memory around the ring: 1 KB of slack to align it and a 1 KB
#: header of mbarriers and merge factors.
_PLANE_OVERHEAD = 2048


class PlanePlan(NamedTuple):
    """Kernel 3's launch: ``cluster`` CTAs a (slot, KV head) along the
    grid's rank axis, ``tiles_per_cta`` contiguous 64-key tiles each (rank
    r holds tiles [r*T, (r+1)*T) of the plane), a ring of ``stages`` K/V
    tile pairs, ``smem_bytes`` of dynamic shared memory a CTA, and the grid
    (rank, KV head, slot)."""

    cluster: int
    tiles_per_cta: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def plane_plan(b: int, s: int, kh: int, g: int, d: int) -> PlanePlan:
    """Kernel 3's plan for B slots, a plane of S keys, KH KV heads of G
    query rows and head dim D: the smallest cluster that gives the card
    two CTAs an SM (B*KH*C >= 264), never a rank with no tile of the
    plane; a ring of up to two tile pairs
    (``csrc/flash_decode_attention_plane.cu``: 2*64*D bf16 a stage)."""
    if s <= 0 or s % PLANE_BLOCK:
        raise ValueError(f"plane decode kernel needs S % {PLANE_BLOCK} == 0, got {s}")
    if not 1 <= g <= _PLANE_MAX_GROUP:
        raise ValueError(f"plane decode kernel takes 1..{_PLANE_MAX_GROUP} query "
                         f"rows per kv head, got {g}")
    tiles = s // PLANE_TILE

    def idle_rank(c):  # the cluster's last rank would start past S
        return (c - 1) * -(-tiles // c) >= tiles

    c = 1
    while (c < PLANE_CLUSTERS[-1] and not idle_rank(2 * c)
           and b * kh * c < _PLANE_TARGET_CTAS):
        c *= 2
    per = -(-tiles // c)
    stages = min(per, _PLANE_STAGES)
    smem = _PLANE_OVERHEAD + stages * 2 * PLANE_TILE * d * 2
    return PlanePlan(c, per, stages, smem, (c, kh, b))


def _plane_lib() -> ctypes.CDLL:
    lib = kernel_build.load(_PLANE)
    fn = lib.flash_decode_attention_plane_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


@kernel_entry
def flash_decode_attention_plane(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D] raw
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [B] int32
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Kernel 3, the Hopper counterpart of the JAX package's legacy
    ``flash_decode_attention_plane`` (``csrc/flash_decode_attention_plane.cu``):
    the function of :func:`flash_decode_attention` on a raw cache, keys
    ``<= pos`` within the window, from the whole plane up to the frontier,
    on a thread-block cluster per (slot, KV head) laid out by
    :func:`plane_plan` and merged through distributed shared memory.
    Kept, as in the JAX package, only to cross-check kernel 2's online
    softmax: the model layer never calls it.  Requires ``S % 128 == 0``, as
    the reference does, a raw (floating) cache and at most 8 query heads
    per KV head, on either device.  Its plain version is
    ``cached_attention``; the wrapper runs that for CPU tensors only, and
    launches or raises for CUDA tensors, under kernel 2's input rules (raw
    form only)."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if s % PLANE_BLOCK:
        raise ValueError(f"plane decode kernel needs S % {PLANE_BLOCK} == 0, got {s}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.dtype.is_floating_point:
            raise TypeError(f"flash_decode_attention_plane takes a raw cache, got "
                            f"{x.dtype} {name} (quantized caches go to kernel 2)")
    if h % kh or h // kh > _PLANE_MAX_GROUP:
        raise ValueError(f"flash_decode_attention_plane kernel takes H/K <= "
                         f"{_PLANE_MAX_GROUP} query rows per kv head, got {h}/{kh}")
    if q.device.type == "cpu":
        return cached_attention(q, k_cache, v_cache, positions, scale=scale,
                                softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention_plane runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, None, None, positions, None,
           max_group=_PLANE_MAX_GROUP, kernel="flash_decode_attention_plane")
    if scale is None:
        scale = d**-0.5
    plan = plane_plan(b, s, kh, h // kh, d)
    lib = _plane_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_attention_plane_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), out.data_ptr(), b, s, h, kh, d,
            k_cache.stride(0), float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), plan.cluster,
            plan.tiles_per_cta, plan.stages, plan.smem_bytes, stream,
        )
    kernel_build.check_launch(lib, _PLANE, rc)
    flash_decode_attention_plane.launches += 1
    return out


#: Kernel 3's launches since the last reset (raw form only).
flash_decode_attention_plane.launches = 0
