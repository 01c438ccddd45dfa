"""Causal flash attention for prefill: the Hopper counterpart of
p2p_llm_tunnel_tpu/ops/pallas_attention.py ``flash_causal_attention``.

The kernel is ``csrc/flash_causal_attention.cu`` (CUDA C++, sm_90a, built
at first use and loaded with ctypes — see ``ops/kernel_build.py``).  Its
plain version is ``ops/attention.causal_attention``: the wrapper runs that
for tensors on the CPU, and only because they lie on the CPU.  For CUDA
tensors it launches the kernel or raises; nothing falls back.

Unlike the TPU kernel there is no ``T % 128`` gate: the kernel masks the
ragged edge itself, so every prefill bucket goes through it.  Rows that
see no key return 0 (the plain version returns the mean of V there; no
real prompt row is such a row — key 0 is always valid for it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.attention import causal_attention

_NAME = "flash_causal_attention"
_SUPPORTED_D = (16, 32, 64, 128, 256)  # every preset's head_dim
_BQ = _BK = 64  # query rows per block, keys per tile
_PAD = 8  # bf16 row padding of the q/K/V tiles

#: The kernel's plain PyTorch version (same function, same layouts).
plain = causal_attention


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    q tile [64, D+8] and two stages each of K and V [64, D+8] in bf16, and
    two stages of the key tile's 64 valid bytes."""
    return 2 * (_BQ + 4 * _BK) * (d + _PAD) + 2 * _BK


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.flash_causal_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return lib


def _check(q, k, v, valid) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_causal_attention takes q [B,T,H,D], k/v [B,T,K,D]")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if tuple(valid.shape) != (b, t) or valid.dtype != torch.bool:
        raise ValueError("valid must be a [B,T] bool tensor")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_causal_attention kernel takes bfloat16 {name}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_causal_attention kernel needs a contiguous, 16-byte aligned {name}")
    if not valid.is_contiguous():
        raise ValueError("flash_causal_attention kernel needs a contiguous valid mask")
    if d not in _SUPPORTED_D:
        raise ValueError(f"flash_causal_attention kernel supports head_dim {_SUPPORTED_D}, got {d}")
    devices = {x.device for x in (q, k, v, valid)}
    if len(devices) != 1:
        raise ValueError(f"flash_causal_attention inputs span devices {devices}")


def flash_causal_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,  # [B, T, K, D]
    valid: torch.Tensor,  # [B, T] bool
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA prefill attention -> [B, T, H, D]; drop-in for
    ``causal_attention``.  ``window`` is a per-layer Python int (None =
    no window)."""
    if q.device.type == "cpu":
        return plain(q, k, v, valid, scale=scale, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_causal_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, valid)
    b, t, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_causal_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), b, t, h, k.shape[2], d, float(scale),
            0.0 if softcap is None else float(softcap),
            t + 1 if window is None else int(window), stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    flash_causal_attention.launches += 1
    return out


#: Kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the engine and reads it after).
flash_causal_attention.launches = 0
