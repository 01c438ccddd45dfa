"""Slot-decode attention: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
``flash_decode_attention_sgrid`` in its raw-KV form.

The kernel is ``csrc/flash_decode_attention.cu`` (CUDA C++, sm_90a, built
at first use and loaded with ctypes — see ``ops/kernel_build.py``).  Its
plain version is ``ops/attention.cached_attention``: the wrapper runs that
for tensors on the CPU, and only because they lie on the CPU.  For CUDA
tensors it launches the kernel or raises; nothing falls back.

The cache arguments may be strided windows of the model's
``[L, B, S_max, K, D]`` cache (``cache[l, :, :view]``): each slot's
``[S, K, D]`` block must be dense, the slot stride is free, so the kernel
reads the view in place with no copy.  The int8/int4 cache forms of the
TPU kernel are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import cached_attention

_NAME = "flash_decode_attention"
_SUPPORTED_D = (16, 32, 64, 128, 256)  # every preset's head_dim
_MAX_GROUP = 8
#: ``window=None``: no key is ever too old, parked rows (pos >= S) included.
_NO_WINDOW = 2**31 - 1

#: The kernel's plain PyTorch version (same function, same layouts).
plain = cached_attention


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.flash_decode_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check(q, k_cache, v_cache, positions) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_attention takes q [B,1,H,D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v cache must be matching [B,S,K,D] tensors")
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    kh = k_cache.shape[2]
    if h % kh or h // kh > _MAX_GROUP:
        raise ValueError(
            f"flash_decode_attention kernel takes H/K <= {_MAX_GROUP} query "
            f"rows per kv head, got {h}/{kh}"
        )
    if d not in _SUPPORTED_D:
        raise ValueError(f"flash_decode_attention kernel supports head_dim {_SUPPORTED_D}, got {d}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode_attention kernel takes bfloat16 {name}, got {x.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode_attention kernel needs a contiguous q")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != kh * d:
            raise ValueError(f"{name}: each slot's [S,K,D] block must be dense")
        if x.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    if k_cache.stride(0) != v_cache.stride(0):
        raise ValueError("k and v caches must share a slot stride")
    if (positions.dtype != torch.int32 or tuple(positions.shape) != (b,)
            or not positions.is_contiguous()):
        raise ValueError("positions must be a contiguous [B] int32 tensor")
    devices = {x.device for x in (q, k_cache, v_cache, positions)}
    if len(devices) != 1:
        raise ValueError(f"flash_decode_attention inputs span devices {devices}")


def flash_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D]
    v_cache: torch.Tensor,  # [B, S, K, D]
    positions: torch.Tensor,  # [B] int32
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query token per slot against its cache -> [B, 1, H, D]; drop-in
    for ``cached_attention``.  ``window`` is a per-layer Python int (None =
    no window)."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, positions, scale=scale,
                     softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, positions)
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d**-0.5
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), out.data_ptr(), b, s, h, kh, d,
            k_cache.stride(0), float(scale),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    flash_decode_attention.launches += 1
    return out


#: Kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the engine and reads it after).
flash_decode_attention.launches = 0
