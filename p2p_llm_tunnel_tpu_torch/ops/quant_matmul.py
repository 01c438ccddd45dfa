"""Dequant-fused weight matmul (kernel 7): ``y = x @ W`` for quantized
weights, the Hopper counterpart of what XLA fuses into the dot's operand
load on the TPU in p2p_llm_tunnel_tpu/models/quant.py (``mm`` :298,
``_dequant4`` :246, ``_int8_dot`` :283, ``head_matmul`` :336).  The JAX
package has no Pallas kernel here; the card needs one because
dequantizing first and calling a library GEMM writes and re-reads a bf16
copy of every weight, more bytes than serving bf16 weights.

The kernel is ``csrc/quant_matmul.cu`` (CUDA C++, sm_90a, built at first
use, loaded with ctypes — ``ops/kernel_build.py``).  Three forms, one
source: ``int8`` (weight-only, the scale after the product), ``int4``
(packed two per byte along the contracted axis, group scales in the
operand) and ``w8a8`` (per-token int8 activations, int8 x int8 -> int32).
Two layouts: ``kn`` (``W [K, N]``, int4 ``[Kp/2, N]`` bytes) for the block
projections and an untied ``lm_head``, and ``nk`` (``W [N, K]``, int4 ``[N,
Kp/2]``) for a tied head over the ``[V, dm]`` embedding.

``plain`` is the kernel's plain PyTorch version and follows the
reference's expression op for op, rounding where it rounds; the wrapper
runs it for tensors on the CPU, and only because they lie on the CPU.  For
CUDA tensors it launches the kernel or raises; nothing falls back.  On the
card the kernel takes bf16 activations and group sizes that are multiples
of 16 (a group spans whole 16-deep k-steps); the engine refuses other
group sizes on the card at construction.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.models.quant import (
    QTensor4,
    _dequant4,
    _int8_dot,
    _quantize_act,
)
from p2p_llm_tunnel_tpu_torch.ops import kernel_build

_NAME = "quant_matmul"
FORMS = ("int8", "w8a8", "int4")
_FORM_ID = {"int8": 0, "w8a8": 1, "int4": 2}
_LAYOUT_ID = {"kn": 0, "nk": 1}
#: The kernel's k-step: an int4 group must span whole steps on the card.
GROUP_MULTIPLE = 16
#: (BM, BN, BK, warps splitting k, stages) of the two plans, as the kernel
#: instantiates them: SMALL for decode steps and verify bursts, LARGE for
#: prefill.
PLANS = {"small": (32, 64, 128, 4, 4), "large": (64, 128, 64, 1, 3)}
#: Rows up to which the SMALL plan runs: a decode step (16 slots + the
#: parked row = 17) and every verify burst (17 x T, T <= 9).
SMALL_MAX_M = 160


def group_size_fence(group_size: int) -> Optional[str]:
    """Why the card cannot serve int4 weights at ``group_size`` (None when
    it can)."""
    if group_size <= 0 or group_size % GROUP_MULTIPLE:
        return (f"quant_group_size {group_size} is not a multiple of "
                f"{GROUP_MULTIPLE}: the int4 matmul kernel applies one group "
                f"scale per 16-deep k-step of its tensor-core products")
    return None


def launch_plan(m: int, n: int) -> dict:
    """The kernel's plan for ``m`` rows and ``n`` output columns: tile
    sizes, slab depth, stages and grid (M tiles fastest, so the M tiles of
    one N tile run side by side and share its weight bytes through L2)."""
    plan = "small" if m <= SMALL_MAX_M else "large"
    bm, bn, bk, warps_k, stages = PLANS[plan]
    return dict(plan=plan, id=0 if plan == "small" else 1, bm=bm, bn=bn,
                bk=bk, warps_k=warps_k, stages=stages,
                grid=(-(-m // bm), -(-n // bn)))


def smem_bytes(plan: str, form: str, layout: str) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: per
    stage the activation tile (rows padded 16 bytes), the weight bytes
    (rows padded 16 bytes) and, for int4, one f32 scale per 16-deep k-step
    and column."""
    bm, bn, bk, _, stages = PLANS[plan]
    es = 1 if form == "w8a8" else 2
    wk = bk // 2 if form == "int4" else bk
    a_bytes = bm * (bk * es + 16)
    w_bytes = wk * (bn + 16) if layout == "kn" else bn * (wk + 16)
    s_bytes = (bk // 16) * bn * 4 if form == "int4" else 0
    return stages * (a_bytes + w_bytes + s_bytes)


def plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, form: str,
          layout: str = "kn", in_dim: Optional[int] = None,
          group_size: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the reference's order:
    int8 ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``; int4 ``x @
    dequant4(w)`` (f32 multiply, one rounding to ``x.dtype``, before the
    product); w8a8 ``(int8_dot(x, q) * scale).to(x.dtype)`` with the
    integer sums exact."""
    kn = layout == "kn"
    if form == "int4":
        w = _dequant4(QTensor4(q, scale, in_dim, group_size, -2 if kn else -1),
                      x.dtype)
        return x @ (w if kn else w.T)
    if form == "w8a8":
        y = _int8_dot(x, q, rhs_contract=0 if kn else 1)
        return (y * scale.to(torch.float32)).to(x.dtype)
    if form != "int8":
        raise ValueError(f"unknown quant_matmul form {form!r}")
    y = x @ (q if kn else q.T).to(x.dtype)
    return y * scale.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load(_NAME)
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def _check(x, q, scale, form, layout, in_dim, group_size):
    """Shapes, dtypes, devices and contiguity the kernel takes; returns
    (K, N, wrows, groups)."""
    if form not in _FORM_ID:
        raise ValueError(f"unknown quant_matmul form {form!r}")
    if layout not in _LAYOUT_ID:
        raise ValueError(f"unknown quant_matmul layout {layout!r}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul kernel takes bfloat16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("quant_matmul kernel takes int8 weight bytes and f32 scales")
    if q.dim() != 2:
        raise ValueError(f"quant_matmul kernel takes a 2-D weight, got {tuple(q.shape)}")
    for name, t in (("weight", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul kernel needs a contiguous {name}")
    devices = {x.device, q.device, scale.device}
    if len(devices) != 1:
        raise ValueError(f"quant_matmul inputs span devices {devices}")
    k = x.shape[-1]
    kn = layout == "kn"
    wrows, n = (q.shape[0], q.shape[1]) if kn else (q.shape[1], q.shape[0])
    if form == "int4":
        if in_dim != k:
            raise ValueError(f"activations of width {k} against an int4 weight "
                             f"of in_dim {in_dim}")
        why = group_size_fence(group_size)
        if why is not None:
            raise ValueError(why)
        groups = scale.shape[0] if kn else scale.shape[1]
        want = (groups, n) if kn else (n, groups)
        if tuple(scale.shape) != want or groups * group_size != 2 * wrows \
                or k > 2 * wrows:
            raise ValueError(f"int4 weight {tuple(q.shape)} and scales "
                             f"{tuple(scale.shape)} do not match in_dim {in_dim}, "
                             f"group_size {group_size}")
        return k, n, wrows, groups
    if wrows != k or tuple(scale.shape) != (n,):
        raise ValueError(f"int8 weight {tuple(q.shape)} ({layout}) and scales "
                         f"{tuple(scale.shape)} do not match activations of width {k}")
    return k, n, wrows, 0


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 form: str, layout: str = "kn", in_dim: Optional[int] = None,
                 group_size: Optional[int] = None) -> torch.Tensor:
    """``x [..., K] @ W -> [..., N]`` in ``x.dtype`` for the quantized weight
    ``(q, scale)`` in ``form`` and ``layout``; drop-in for ``plain``."""
    if x.device.type == "cpu":
        return plain(x, q, scale, form=form, layout=layout, in_dim=in_dim,
                     group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    k, n, wrows, groups = _check(x, q, scale, form, layout, in_dim, group_size)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    xs = None
    if form == "w8a8":
        x2, xs = _quantize_act(x2)
        xs = xs.reshape(m).contiguous()
    plan = launch_plan(m, n)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quant_matmul_launch(
            x2.data_ptr(), None if xs is None else xs.data_ptr(), q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), m, n, k, wrows, groups,
            group_size or 0, _FORM_ID[form], _LAYOUT_ID[layout], plan["id"],
            stream,
        )
    kernel_build.check_launch(lib, _NAME, rc)
    quant_matmul.launches += 1
    quant_matmul.form_launches[form] += 1
    return out.reshape(*lead, n)


#: Kernel launches since the last reset, in total and per form (plain
#: ints; chip_smoke.py zeroes them before driving the engine and reads them
#: after).
quant_matmul.launches = 0
quant_matmul.form_launches = dict.fromkeys(FORMS, 0)
