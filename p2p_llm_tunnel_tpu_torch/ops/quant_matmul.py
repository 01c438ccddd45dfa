"""Dequant-fused weight matmul (kernel 7): ``y = x @ W`` for quantized
weights, the Hopper counterpart of what XLA fuses into the dot's operand
load on the TPU in p2p_llm_tunnel_tpu/models/quant.py (``mm`` :298,
``_dequant4`` :246, ``_int8_dot`` :283 with ``_quantize_act`` :275,
``head_matmul`` :336).  The JAX package has no Pallas kernel here; the
card needs one because dequantizing first and calling a library GEMM
writes and re-reads a bf16 copy of every weight, more bytes than serving
bf16 weights.

The kernel is ``csrc/quant_matmul.cu`` (CUDA C++, sm_90a, built at first
use, loaded with ctypes — ``ops/kernel_build.py``).  Three forms, one
source: ``int8`` (weight-only, the scale after the product), ``int4``
(packed two per byte along the contracted axis, group scales in the
operand) and ``w8a8`` (per-token int8 activations, quantized by the
source's own row kernel in the same call, int8 x int8 -> int32).  Two
layouts: ``kn`` (``W [K, N]``, int4 ``[Kp/2, N]`` bytes) for the block
projections and an untied ``lm_head``, and ``nk`` (``W [N, K]``, int4 ``[N,
Kp/2]``) for a tied head over the ``[V, dm]`` embedding.

``launch_plan`` chooses one of two plans by rows: ``decode`` (M <= 160:
decode steps and verify bursts; tiles of 24 or 32 rows x 128 columns on
wgmma with the dequantized weights as its register operand, weight-only
stages in a ring of up to 4 filled by TMA, the activations in a few
large pieces) and ``prefill`` (128 x 256 tiles, each weight slab
dequantized once per block into a shared tile that wgmma reads).  Both
split the contracted axis when the tiles
alone would leave SMs idle: the most splits that keep the grid within
one wave of ``SPLIT_TARGET`` blocks, at most ``SPLIT_CAP``, each split whole units of ``lcm(slab, group size)``; the
blocks of one output tile merge their partials in split order inside the
launch (the last to arrive adds them), so one product is one launch and
bitwise the same from one launch to the next.  The wrapper checks each
shape once (``_PLANS`` holds its plan, its C arguments and, for decode
shapes, its workspace) and the tensors every call.

``plain`` is the kernel's plain PyTorch version and follows the
reference's expression op for op, rounding where it rounds; the wrapper
runs it for tensors on the CPU, and only because they lie on the CPU.  For
CUDA tensors it launches the kernel or raises; nothing falls back.  On the
card the kernel takes bf16 activations and every shape the reference
serves quantized: weight rows in whole 16-byte pieces, stored padded where
the logical row is not (``models/quant.kernel_layout``, which the engine
applies to its tree; the wrapper raises on an unpadded row), a contracted
length of any size (the wrapper zero-pads x to a multiple of 16), and any
even int4 group size (``shape_fence`` names the one other limit, which no
real shape reaches).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from p2p_llm_tunnel_tpu_torch.models.quant import (
    QTensor4,
    _dequant4,
    _int8_dot,
    _quantize_act,
)
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.utils.launch_count import kernel_entry

_NAME = "quant_matmul"
FORMS = ("int8", "w8a8", "int4")
_FORM_ID = {"int8": 0, "w8a8": 1, "int4": 2}
_LAYOUT_ID = {"kn": 0, "nk": 1}
#: Rows up to which the decode plan runs: a decode step (16 slots + the
#: parked row = 17) and every verify burst (17 x T, T <= 9).
SMALL_MAX_M = 160
#: (rows, columns, most ring stages) of a tile in each plan (decode rows
#: 24 up to 24 rows); the slab depth is ``slab_k``, the stages as many as
#: shared memory holds (``launch_plan``).
PLANS = {"decode": (32, 128, 4), "prefill": (128, 256, 4)}
#: Dynamic shared memory one block may use (227 KB).
MAX_SMEM = 232448
_PLAN_ID = {"decode": 0, "prefill": 1}
#: Blocks of one wave, which a plan's split choice fills: two per SM of the
#: H100's 132 at decode (weight-stream bound), one per SM at prefill (a
#: block holds one SM's tensor cores).
SPLIT_TARGET = {"decode": 264, "prefill": 132}
#: Most splits of one product: each adds a partial to the merge.
SPLIT_CAP = 16
#: Budget of one decode block: two blocks per SM (233472 bytes less 1 KB
#: reserved per block).
DECODE_SMEM_BUDGET = 233472 // 2 - 1024


def shape_fence(k: int, form: str, group_size: Optional[int] = None) -> Optional[str]:
    """Why kernel 7 cannot take a product contracting ``k`` positions in
    ``form`` (None when it can).  Every width and contracted length is
    taken; an int4 group must be even (a packed byte's two k share its
    scale, as the reference's quantizer requires) and small enough that the
    kernel's group index — a multiply-high by ``ceil(2**32 / (gs / 2))``
    over the packed byte rows — is exact."""
    if form != "int4":
        return None
    gs = group_size or 0
    if gs <= 0 or gs % 2:
        return f"int4 group size {gs} is not a positive even number"
    wrows = -(-k // gs) * gs // 2
    if (wrows + 256) * (gs // 2) > 2**32:
        return (f"int4 group size {gs} over {k} contracted positions: the "
                f"kernel's group index is exact up to 2**32 byte-row x half-group")
    return None


def model_fence(cfg, quant: str, group_size: int, tp: int = 1) -> Optional[str]:
    """Why the card cannot serve ``cfg`` under ``--quant quant`` (None when
    it can): every contracted length kernel 7 runs — the block projections'
    and the head's, at the shard shapes of a ``tp``-rank run (the
    row-parallel ``wo`` and ``w_down`` contract K/tp positions) — must pass
    ``shape_fence``."""
    if quant not in ("int8", "w8a8", "int4"):
        return None
    form = "int4" if quant == "int4" else "int8"
    for name, k in (("wq/wk/wv/w_gate/w_up/head", cfg.dim),
                    ("wo", cfg.n_heads * cfg.head_dim // tp),
                    ("w_down", cfg.ffn_dim // tp)):
        why = shape_fence(k, form, group_size)
        if why is not None:
            return f"kernel 7 cannot take {name} (K {k}): {why}"
    return None


def slab_k(plan: str, form: str) -> int:
    """Contracted positions of one slab (a ring stage's weights): 16 KB of
    weights at decode; at prefill one 128-byte row of x (64 bf16, or 128
    int8 for W8A8), the span of wgmma's 128-byte swizzle."""
    if plan == "decode":
        return 256 if form == "int4" else 128
    return 128 if form == "w8a8" else 64


def scale_rows(plan: str, gs: int) -> int:
    """int4 scale rows a stage holds: the most groups one slab touches
    (slabs start at multiples of the slab depth; its last packed byte holds
    k ``bk - 2`` and ``bk - 1``)."""
    bk = slab_k(plan, "int4")
    period = math.lcm(bk, gs) // bk
    return max((s * bk + bk - 2) // gs - (s * bk) // gs + 1 for s in range(period))


def stage_layout(plan: str, form: str, layout: str, gs: int = 128) -> dict:
    """One ring stage of a plan, as the kernel lays it out: the activation
    tile (prefill only: decode keeps its activations in separate pieces),
    the weight bytes (KN: 128-byte TMA rows; NK: rows padded 16 bytes)
    and, for int4, the scale rows — each part's reserved bytes and the
    bytes its copies fill — rounded to 1 KB."""
    bm, bn, _ = PLANS[plan]
    bk = slab_k(plan, form)
    es = 1 if form == "w8a8" else 2
    wk = bk // 2 if form == "int4" else bk
    # KN: TMA boxes of 128 columns, 128-byte rows (swizzled); NK: rows
    # padded 16.
    w_rows, w_row = (wk * (bn // 128), 128) if layout == "kn" else (bn, wk + 16)
    srows = scale_rows(plan, gs) if form == "int4" else 0
    x_bytes = bm * 128 if plan == "prefill" else 0  # swizzled 128-byte rows
    parts = dict(x_bytes=x_bytes, w_bytes=w_rows * w_row, s_bytes=srows * bn * 4)
    align = 1024  # TMA's 128-byte swizzle atom
    # Copied per full slab: the x tile's real bytes, the weight bytes, and
    # the scale rows of the groups a slab starting at k 0 touches.
    return dict(parts, srows=srows, w_row=w_row,
                stage_bytes=-(-sum(parts.values()) // align) * align,
                x_copied=bm * bk * es if plan == "prefill" else 0,
                w_copied=wk * bn,
                s_copied=((bk - 2) // gs + 1) * bn * 4 if form == "int4" else 0)


def smem_bytes(plan: dict) -> int:
    """Dynamic shared memory of one block of ``plan`` (``launch_plan``'s
    dict), as csrc/quant_matmul.cu's ``smem_bytes`` computes it: 1 KB of
    alignment slack and a 1 KB barrier header, then (decode) two slots of
    the tile's rows of an ``xpiece``-deep activation piece, in 128-byte
    blocks, or (prefill) three dequantized [256 x 128-byte] tiles, then the
    ring of stages."""
    st = plan["stage"]
    ring = plan["stages"] * st["stage_bytes"]
    es = 1 if plan["form"] == "w8a8" else 2
    if plan["plan"] == "decode":
        return 2048 + 2 * plan["xpiece"] * es * plan["bm"] + ring
    return 2048 + 3 * plan["bn"] * 128 + ring


def split_count(tiles: int, most: int, units: int, target: int) -> int:
    """Splits of the contracted axis for ``tiles`` output tiles: none when
    the tiles alone fill ``target`` blocks (one wave); else the most (up to
    ``most``) that keep the grid within that wave, preferring a count that
    divides the ``units`` evenly (equal splits finish together).  Measured
    on the card: one full wave beats a wave and a part (llama3-8b int4 at
    M 17: wq/wo 0.0178 ms at 8 splits against 0.0249 at 14)."""
    if tiles >= target or most <= 1:
        return 1
    lim = max(1, min(most, target // tiles))
    return next((s for s in range(lim, 0, -1) if units % s == 0), lim)


def launch_plan(m: int, n: int, k: int, form: str = "int4", layout: str = "kn",
                group_size: int = 128) -> dict:
    """Kernel 7's launch for ``m`` rows, ``n`` output columns and ``k``
    contracted positions: the plan, tile and slab sizes, the grid (M tiles
    fastest, so the M tiles of one column tile share its weight bytes
    through L2; split-K on z), the split unit (whole slabs and whole int4
    groups), the decode plan's activation piece, the stage layout, shared
    memory, the merge workspace (rows of ``ldp``: N rounded up to 4) and its
    arrival counters.  A decode ring that leaves no room for two blocks an
    SM (int4 groups of a few k: many scale rows a stage) takes one block's
    shared memory."""
    plan = "decode" if m <= SMALL_MAX_M else "prefill"
    bm, bn, stages = PLANS[plan]
    if plan == "decode" and m <= 24:
        bm = 24  # wgmma's N: a decode step's 17 rows in one tile
    bk = slab_k(plan, form)
    gs = group_size if form == "int4" else bk
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    nslabs = -(-k // bk)
    unit = math.lcm(bk, gs) // bk if form == "int4" else 1
    units = -(-nslabs // unit)
    splits = split_count(tiles_m * tiles_n, min(units, SPLIT_CAP), units,
                         SPLIT_TARGET[plan])
    st = stage_layout(plan, form, layout, gs)
    out = dict(plan=plan, id=_PLAN_ID[plan], form=form, m=m, bm=bm, bn=bn, bk=bk,
               grid=(tiles_m, tiles_n, splits), splits=splits,
               unit_slabs=unit, nslabs=nslabs, srows=max(st["srows"], 1),
               stage=st, xpiece=0, stages=stages)
    if plan == "decode":
        # The deepest ring (up to 4 stages) that leaves two activation
        # slots of at least one slab within two blocks an SM, else within
        # one.
        es = 1 if form == "w8a8" else 2
        longest = -(-units // splits) * unit * bk

        def piece(budget, n_st):  # k of the activation slots beside the ring
            return (budget - 2048 - n_st * st["stage_bytes"]) // 2 // (es * bm) // bk * bk

        fit = next(((n_st, piece(b, n_st)) for b in (DECODE_SMEM_BUDGET, MAX_SMEM)
                    for n_st in range(stages, 1, -1) if piece(b, n_st) >= bk), None)
        if fit is None:
            raise ValueError(f"kernel 7 has no decode ring for {form} at group "
                             f"size {group_size}")
        out["stages"], out["xpiece"] = fit[0], min(fit[1], longest)
    else:
        # One block an SM: the deepest ring beside the three tiles.
        out["stages"] = min(stages, (MAX_SMEM - 2048 - 3 * bn * 128) // st["stage_bytes"])
    out["smem"] = smem_bytes(out)
    acc = 4  # f32 or int32 partials
    out["ldp"] = -(-n // 4) * 4
    out["workspace_bytes"] = splits * m * out["ldp"] * acc if splits > 1 else 0
    out["counters"] = tiles_m * tiles_n if splits > 1 else 0
    return out


def split_ranges(plan: dict, k: int):
    """The contracted range ``[k0, k1)`` of each split of ``plan``, in split
    order, as the kernel's ``split_range`` cuts them."""
    bk, unit, splits = plan["bk"], plan["unit_slabs"], plan["splits"]
    nslabs = plan["nslabs"]
    units = -(-nslabs // unit)
    out = []
    for s in range(splits):
        s0 = min(s * units // splits * unit, nslabs)
        s1 = min((s + 1) * units // splits * unit, nslabs)
        out.append((s0 * bk, min(s1 * bk, k)))
    return out


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


_FN = None


def _fn():
    """The kernel's C entry point, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = kernel_build.load(_NAME).quant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10
        _FN = fn
    return _FN


def _check_shapes(k, form, layout, qshape, sshape, in_dim, group_size):
    """What the kernel takes of the shapes alone; returns (N, wrows,
    groups).  Cached per shape and strides by ``quant_matmul``."""
    if form not in _FORM_ID:
        raise ValueError(f"unknown quant_matmul form {form!r}")
    if layout not in _LAYOUT_ID:
        raise ValueError(f"unknown quant_matmul layout {layout!r}")
    if len(qshape) != 2:
        raise ValueError(f"quant_matmul kernel takes a 2-D weight, got {qshape}")
    kn = layout == "kn"
    wrows, n = (qshape[0], qshape[1]) if kn else (qshape[1], qshape[0])
    why = shape_fence(k, form, group_size)
    if form == "int4":
        if in_dim != k:
            raise ValueError(f"activations of width {k} against an int4 weight "
                             f"of in_dim {in_dim}")
        if why is not None:
            raise ValueError(f"quant_matmul kernel: {why}")
        groups = sshape[0] if kn else sshape[1]
        want = (groups, n) if kn else (n, groups)
        if sshape != want or groups * group_size != 2 * wrows or k > 2 * wrows:
            raise ValueError(f"int4 weight {qshape} and scales {sshape} do not "
                             f"match in_dim {in_dim}, group_size {group_size}")
        return n, wrows, groups
    if wrows != k or sshape != (n,):
        raise ValueError(f"int8 weight {qshape} ({layout}) and scales {sshape} "
                         f"do not match activations of width {k}")
    if why is not None:
        raise ValueError(f"quant_matmul kernel: {why}")
    return n, wrows, 0


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride (elements) of a 1-D or 2-D tensor whose rows are
    dense and lie whole 16-byte pieces apart: padded rows, as
    ``models/quant.kernel_layout`` stores them."""
    if t.dim() == 1:
        if t.stride(0) != 1:
            raise ValueError(f"quant_matmul kernel needs a dense {name}")
        return t.shape[0]
    ld = t.stride(0)
    if t.stride(1) != 1 or ld < t.shape[1] or (ld * t.element_size()) % 16:
        raise ValueError(
            f"quant_matmul kernel needs {name} rows of whole 16-byte pieces "
            f"(shape {tuple(t.shape)}, strides {t.stride()}): lay the tree out "
            f"with models.quant.kernel_layout")
    return ld


def _check_tensors(x, q, scale):
    """What the kernel takes of these tensors: dtypes, one device,
    16-byte aligned weight and scales in rows of whole 16-byte pieces;
    returns their row strides (checked every call)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul kernel takes bfloat16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("quant_matmul kernel takes int8 weight bytes and f32 scales")
    if q.device != x.device or scale.device != x.device:
        raise ValueError(f"quant_matmul inputs span devices "
                         f"{ {x.device, q.device, scale.device} }")
    for name, t in (("weight", q), ("scale", scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"quant_matmul kernel needs a 16-byte aligned {name}")
    return _row_stride(q, "weight"), _row_stride(scale, "scale")


#: Per-device arrival counters of the split-K merge, int32, zeroed once and
#: grown as needed: the last block of an output tile leaves its counter 0,
#: so the next launch on the same stream — which starts only after this one
#: ends — finds every counter at 0.  The engine issues every product on one
#: stream.
_ARRIVALS: dict = {}
#: Per shape key (device, rows, K, form, layout, weight and scale shapes,
#: in_dim, group size): the checked shape facts and the launch's integer
#: arguments as a C array, and for decode-plan shapes (a bounded set: rows
#: <= 160) the workspace, arrival counters and W8A8 scratch, made once.
_PLANS: dict = {}


def _arrivals(device: torch.device, count: int) -> torch.Tensor:
    arr = _ARRIVALS.get(device)
    if arr is None or arr.numel() < count:
        arr = _ARRIVALS[device] = torch.zeros(max(count, 1024), dtype=torch.int32,
                                              device=device)
    return arr


def _buffers(p: dict, device, m: int, ldx: int, form: str):
    """(xq, xs, part, arrivals) pointers of one launch, in the C entry
    point's order — W8A8's quantized activations (rows of ``ldx``) and
    scales, the split-K workspace (no memset: every partial the merge
    stores is written first) and counters — and the tensors that hold
    them."""
    part = arrivals = xq = xs = None
    if p["splits"] > 1:
        dtype = torch.int32 if form == "w8a8" else torch.float32
        part = torch.empty(p["splits"] * m * p["ldp"], dtype=dtype, device=device)
        arrivals = _arrivals(device, p["counters"])
    if form == "w8a8":
        xq = torch.empty((m, ldx), dtype=torch.int8, device=device)
        xs = torch.empty((m,), dtype=torch.float32, device=device)
    held = (xq, xs, part, arrivals)
    return tuple(None if t is None else t.data_ptr() for t in held), held


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer handle
    (PyTorch's raw getter where it has one: no Stream object a call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _entry(key, m, k, form, layout, qshape, sshape, in_dim, group_size, device,
           ldw, lds):
    n, wrows, groups = _check_shapes(k, form, layout, qshape, sshape, in_dim,
                                     group_size)
    gs = group_size if form == "int4" else 0
    p = launch_plan(m, n, k, form, layout, gs or 128)
    ldx = -(-k // 16) * 16
    geo = (ctypes.c_int * 17)(m, n, k, wrows, groups, gs, _FORM_ID[form],
                              _LAYOUT_ID[layout], p["id"], p["splits"],
                              p["unit_slabs"], p["xpiece"], p["srows"], p["stages"],
                              ldx, ldw, lds)
    bufs = _buffers(p, device, m, ldx, form) if m <= SMALL_MAX_M else None
    entry = _PLANS[key] = (n, p, ldx, ctypes.addressof(geo), bufs, geo)
    return entry


@kernel_entry
def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 form: str, layout: str = "kn", in_dim: Optional[int] = None,
                 group_size: Optional[int] = None) -> torch.Tensor:
    """``x [..., K] @ W -> [..., N]`` in ``x.dtype`` for the quantized weight
    ``(q, scale)`` in ``form`` and ``layout``; drop-in for ``plain``."""
    device = x.device
    if device.type == "cpu":
        return plain(x, q, scale, form=form, layout=layout, in_dim=in_dim,
                     group_size=group_size)
    if device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {device}")
    ldw, lds = _check_tensors(x, q, scale)
    k = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, k)
    m = x2.shape[0]
    key = (device, m, k, form, layout, q.shape, scale.shape, in_dim, group_size,
           ldw, lds)
    entry = _PLANS.get(key)
    if entry is None:
        entry = _entry(key, m, k, form, layout, tuple(q.shape), tuple(scale.shape),
                       in_dim, group_size, device, ldw, lds)
    n, p, ldx, geo_ptr, bufs, _geo = entry
    if ldx != k:
        # A K tail: rows of whole 16 k, zero past K (the kernel reads them
        # as 0; W8A8's quantizer finds no larger |x| there).
        x2 = torch.nn.functional.pad(x2, (0, ldx - k))
    elif not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    ptrs, _held = bufs or _buffers(p, device, m, ldx, form)
    fn = _FN or _fn()
    if device.index == torch.cuda.current_device():
        rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), *ptrs,
                geo_ptr, _raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                    *ptrs, geo_ptr, _raw_stream(device.index))
    if rc:
        kernel_build.check_launch(kernel_build.load(_NAME), _NAME, rc)
    quant_matmul.launches += 1
    quant_matmul.form_launches[form] += 1
    return out if x.dim() == 2 else out.reshape(*x.shape[:-1], n)


#: Products since the last reset, in total and per form, one per call that
#: launched (W8A8's quantizer kernel is part of its product; plain ints;
#: chip_smoke.py zeroes them before driving the engine and reads them
#: after).
quant_matmul.launches = 0
quant_matmul.form_launches = dict.fromkeys(FORMS, 0)
