#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel of the port from ``p2p_llm_tunnel_tpu_torch/csrc`` (one nvcc per
   source, started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and
   one library call that computes the same function (a yardstick the port
   never calls); check, untimed, the head geometries of the other presets;
3. serve llama3-8b at full width (random bf16 weights from a seed) through
   the tunnel — loopback channel, ``run_serve`` + ``run_proxy``, real HTTP
   — with concurrent SSE and NDJSON streams on the plain (non-mux) engine,
   and check that the prefill and decode kernels' launch counters rose by
   exactly one per layer (32) per prefill wave and per decode step;
4. run one prompt's prefill and four teacher-forced decode steps through
   the kernel path and the plain path on the same weights and bound the
   logits' difference — with the raw cache and kernel 2, and with the int4
   cache and the fused decode layer; then a verify burst (kernel 5) over
   the greedy tokens of four fused decode steps against those steps'
   logits (within 5% of their range, argmax agreement at least 0.8);
5. serve the same weights again on the serve CLI's default engine (mux,
   prefix pool, conversation cache) with ``--ragged-prefill``: 8
   two-turn conversations sharing a ~300-token system prompt, every second
   turn resending its first turn and the answer; check every stream
   finished, the prefix / dedup / conversation counters rose, each second
   turn's pool hit reached into its first turn's answer, and the ragged
   kernel launched exactly 32 times per ragged dispatch;
6. the same conversations on the quantized caches: (a) ``--kv-quant int4
   --fused-decode-layer --ragged-prefill`` — packed int4 pool pages, the
   fused decode layer 32 times per decode step and kernel 2 never, the
   ragged kernel 32 times per dispatch, both in their int4 forms; (b)
   ``--kv-quant int8`` — kernel 2's int8 form 32 times per step; (c) a
   few short streams on each engine that runs a remaining (kernel, KV
   form) pair, so every row of the kernel table launched on a main path;
7. prompt-lookup speculation: the conversations of 6a on ``--kv-quant int4
   --fused-decode-layer --ragged-prefill --spec-ngram 3 --spec-k 4
   --spec-k-max 8`` — kernel 5 (int4) 32 times per verify burst, kernel 4
   32 times per plain decode step, kernel 2 never, proposals made, the
   proposer's state released; then short streams with speculation on the
   raw and int8 fused engines and on the unfused int4 engine (the chunk
   path's int4 splice).

Phase 2 holds every kernel in every KV form (raw, int8, int4): attention
within tolerance, quantized cache bytes and scales bit-exact; kernel 5
also within the same tolerance of T sequential kernel-4 launches (the
max difference printed; caches bit-exact); kernels 2, 4 and 5 also
bitwise equal over two launches on equal inputs; kernel 3 (raw only; no
serving path calls it) also against kernel 2; kernel 6 also at q-block
widths 8 and 32.  Kernel rows report the median of three timing runs and
their spread; every kernel row and its library call is timed L2-cold (the
inputs rotate over copies, or the layer over a stacked cache, larger than
twice the L2) and carries the kernel's device time alone
(torch.profiler).  The line before the last is
the kernel table as one JSON object, one row per (kernel, KV form); the
last line is ``{"ok": true, "device": {...}}``.
``--profile`` adds a torch.profiler window over the plain-loop engine and
the mux engines of phases 5, 6a and 7 with every slot busy (device busy
share, device time by kernel), and the CUDA launches of one decode step
on the mux engines of phases 5 and 6a (fused decode layer off and on) and
of one verify burst on phase 7's.
``--kernels-only`` stops after phase 2.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time
from typing import Optional

# Published peaks of one H100 SXM (dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

MODEL = "llama3-8b"
NUM_SLOTS = 16
MAX_SEQ = 1024
N_REQUESTS = 8  # concurrent streams through the tunnel, SSE and NDJSON
MAX_TOKENS = 64  # tokens each stream asks for
#: The kernel-table row the JSON line reports: the prefill bucket and the
#: decode view the main path's prompts (120-400 bytes) land in.
JSON_SHAPES = {"flash_causal_attention": "T256", "flash_decode_attention": "S512",
               "flash_decode_attention_plane": "S512",
               "fused_decode_layer": "view512", "fused_spec_decode_layer": "T5 view512",
               "ragged_prefill_attention": "TOT1024"}
#: Kernel 3 has no serving path (in the JAX package either): its row counts
#: phase 2's launches and is exempt from the main-path launch check.
CROSS_CHECK_ONLY = {"flash_decode_attention_plane":
                    "cross-check only: no serving path in the JAX package either"}
#: The ``__global__`` names of the port's kernels, as the profiler reports
#: them (``--profile`` lists each beside the window's top 14).
PORT_KERNEL_NAMES = ("flash_causal_kernel", "flash_decode_kernel",
                     "plane_decode_kernel", "fused_decode_layer_kernel",
                     "fused_spec_kernel", "ragged_prefill_kernel")
# Phase 5: conversations of the mux phase, their system prompt and turns.
N_CONV = 8
SYSTEM_PROMPT = ("You are the tunnel's assistant. Answer briefly, cite the "
                 "design when you can, and never invent numbers. ") * 3
TURN1_TOKENS = 64
TURN2_TOKENS = 32
# Tolerance of a kernel against its plain version on bf16 inputs: both
# compute in fp32, the kernels round P to bf16 for the PV product, and
# both round the output to bf16 (|out| <~ 4 here).
ATOL, RTOL = 3e-2, 2e-2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int = 20, warm: int = 3, runs: int = 3):
    """(median, spread) in ms per call over ``runs`` timing runs of
    ``iters`` calls each (CUDA events; spread = slowest - fastest run)."""
    times = run_times(fn, iters, warm, runs)
    return statistics.median(times), max(times) - min(times)


def run_times(fn, iters: int = 20, warm: int = 3, runs: int = 3) -> list:
    """ms per call of each of ``runs`` timing runs of ``iters`` calls
    (CUDA events), after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def dev_us(event) -> float:
    """A torch.profiler event's device time in microseconds."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0) or 0)


def device_ms(fn, kernel: Optional[str], iters: int = 50) -> float:
    """Device time per launch of the CUDA kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn`` under torch.profiler: the
    kernel alone, without the host time between launches that CUDA events
    also see when a call enqueues slower than the card runs it.  With
    ``kernel`` None: the device time of every kernel ``fn`` launches, per
    call (a library call's).

    A profiler window can come back with some or all of the device's
    events missing (seen on the card): a kernel's time is averaged over
    the launches the window shows, and a window that shows none is taken
    again; a library call's total is the fullest of three windows (a
    window never shows more than ran).  Fails after three empty windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return prof.key_averages()

    fn()
    torch.cuda.synchronize()
    if kernel is None:
        total = max(sum(dev_us(e) for e in window()) for _ in range(3))
        if total <= 0:
            raise AssertionError("the profiler saw no device time in three windows")
        return total / iters / 1e3
    for _ in range(3):
        events = [e for e in window() if kernel in e.key]
        count = sum(e.count for e in events)
        if count:
            return sum(dev_us(e) for e in events) / count / 1e3
    raise AssertionError(f"the profiler saw no launch of {kernel} in three windows")


def library_times(fn, iters: int = 50) -> dict:
    """A library yardstick's time: ``library_ms`` by CUDA events (median
    of three runs) and ``library_device_ms``, the device time of all its
    kernels per call."""
    return dict(library_ms=timed_ms(fn, iters=iters)[0],
                library_device_ms=device_ms(fn, None))


def kernel_ms(fn, iters: int = 20) -> dict:
    """A kernel row's time: ``ms`` (median of three runs) and ``ms_spread``."""
    ms, spread = timed_ms(fn, iters=iters)
    return dict(ms=ms, ms_spread=spread)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, ref: str = "its plain version") -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = ATOL + RTOL * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    if (err > limit).any():
        raise AssertionError(
            f"{name}: kernel disagrees with {ref}: max |err| "
            f"{err.max().item():.4g} (tolerance {ATOL} + {RTOL}*|ref|)"
        )
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

#: Live bytes a rotation over input copies or stacked layers must exceed
#: for an L2-cold time: over twice the H100's 50 MB L2, with margin.
L2_COLD_BYTES = 128e6


def cold_layers(positions, view, kh, d, form) -> int:
    """Layers of a stacked cache whose live bytes (each slot's committed
    keys and their scales), rotated over, exceed ``L2_COLD_BYTES``."""
    keys = sum(min(p, view) for p in positions)
    per_layer = 2 * keys * kh * (d * ELEM_BYTES[form] + (4 if form else 0))
    return max(2, -(-int(L2_COLD_BYTES) // int(per_layer)) + 1)


def rotating(fn, layers: int):
    """``fn(layer)`` over layers 0, 1, ..., layers - 1, 0, ... per call."""
    import itertools

    it = itertools.count()
    return lambda: fn(next(it) % layers)


def prefill_case(b, t, h, kh, d, lengths, window=None, softcap=None, seed=0):
    """Kernel 1 against its plain version; timed L2-cold with its device
    time, its bound and an SDPA yardstick: kernel and library call each
    rotate over copies of their inputs whose bytes together exceed
    ``L2_COLD_BYTES``."""
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, t, kh, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, t, kh, d), generator=g, device="cuda").bfloat16()
    lens = torch.tensor(lengths, device="cuda")
    valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    kw = dict(softcap=softcap, window=window)
    got = fa.flash_causal_attention(q, k, v, valid, **kw)
    want = fa.plain(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    err = check_close(f"flash_causal_attention T={t}", got, want)

    i = torch.arange(t, device="cuda")[:, None]
    j = torch.arange(t, device="cuda")[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & ((i - j) < window)
    mask = mask[None] & valid[:, None, :]  # [B, T, T]
    pairs = int(mask.sum().item()) * h  # attended (query, key) pairs
    nbytes = 2 * b * t * (2 * h + 2 * kh) * d + b * t
    flops = 4 * d * pairs
    in_bytes = 2 * b * t * (h + 2 * kh) * d + b * t
    sets = max(2, -(-int(L2_COLD_BYTES) // in_bytes) + 1)
    ins = [(q, k, v, valid)] + [tuple(x.clone() for x in (q, k, v, valid))
                                for _ in range(sets - 1)]
    launch = rotating(lambda n: fa.flash_causal_attention(*ins[n], **kw), sets)
    row = dict(
        shape=f"B{b} T{t} H{h} K{kh} D{d}" + (f" window{window}" if window else "")
        + (f" softcap{softcap}" if softcap else "")
        + ("" if min(lengths) == t else " padded") + f" L2-cold{sets}",
        max_abs_err=err,
        **kernel_ms(launch),
        device_ms=device_ms(launch, "flash_causal_kernel"),
        plain_ms=timed_ms(lambda: fa.plain(q, k, v, valid, **kw), iters=5)[0],
    )
    row.update(library_ms=None, library_device_ms=None)
    if softcap is None:
        lib_ins = [(qs.transpose(1, 2),
                    ks.transpose(1, 2).repeat_interleave(h // kh, dim=1),
                    vs.transpose(1, 2).repeat_interleave(h // kh, dim=1))
                   for qs, ks, vs, _ in ins]
        am = mask[:, None]
        row.update(library_times(rotating(
            lambda n: F.scaled_dot_product_attention(*lib_ins[n], attn_mask=am),
            sets), iters=20))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


#: The KV cache forms and the bytes one cached element takes in each.
FORMS = (None, "int8", "int4")
ELEM_BYTES = {None: 2, "int8": 1, "int4": 0.5}


def row_name(kname: str, form) -> str:
    """The kernel table's name of one (kernel, KV form) row."""
    return kname if form is None else f"{kname}_{form}"


def cache_form(x, form, seq_axis):
    """bf16 cache values ``x`` in ``form``: (values, k_scale or None) —
    int8 values, or int4 values packed two tokens per byte along
    ``seq_axis`` — through the port's own quantizers."""
    from p2p_llm_tunnel_tpu_torch.models import quant, transformer as tr

    if form is None:
        return x, None
    vals, scale = (tr._quant_kv4 if form == "int4" else tr._quant_kv)(x)
    if form == "int4":
        vals = quant.pack_int4(vals, axis=seq_axis)
    return vals.contiguous(), scale.contiguous()


def decode_inputs(b, s, h, kh, d, positions, form, s_max, layers, seed):
    """Kernel 2's inputs: q, the positions and ``view(layer)``, which gives
    the strided ``[:, :S]`` windows of one layer of a stacked ``[L, B,
    S_max, K, D]`` cache in ``form`` (and the scale windows in the
    kwargs)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    kc, ks = cache_form(torch.randn((layers, b, s_max, kh, d), generator=g,
                                    device="cuda").bfloat16(), form, 2)
    vc, vs = cache_form(torch.randn((layers, b, s_max, kh, d), generator=g,
                                    device="cuda").bfloat16(), form, 2)
    rows = s // 2 if form == "int4" else s
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")

    def view(lay):
        kw = {}
        if form is not None:
            kw = dict(k_scale=ks[lay, :, :s], v_scale=vs[lay, :, :s], kv_quant=form)
        return kc[lay, :, :rows], vc[lay, :, :rows], kw

    return q, pos, view


def decode_library(q, view, s, pos, form, copies: int):
    """The SDPA yardstick of kernels 2 and 3, L2-cold: one call per copy,
    rotating over ``copies`` dequantized bf16 copies of the first layers
    of the stacked cache, KV heads expanded."""
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    h = q.shape[2]
    ins = []
    for lay in range(copies):
        kd, vd, kw = view(lay)
        kh = kd.shape[2]
        if form is not None:
            kd = da.dequant_f32(kd, kw["k_scale"], form).bfloat16()
            vd = da.dequant_f32(vd, kw["v_scale"], form).bfloat16()
        ins.append([x.transpose(1, 2).repeat_interleave(h // kh, dim=1)
                    for x in (kd, vd)])
    qh = q.transpose(1, 2)
    am = (torch.arange(s, device="cuda")[None, :] <= pos[:, None].long())
    am = am[:, None, None, :]
    return library_times(rotating(
        lambda n: F.scaled_dot_product_attention(qh, *ins[n], attn_mask=am),
        copies))


def library_copies(copy_bytes: float, most: int) -> int:
    """Copies an L2-cold yardstick rotates over: enough to exceed
    ``L2_COLD_BYTES``, at least two, at most ``most``."""
    return max(2, min(most, -(-int(L2_COLD_BYTES) // int(copy_bytes)) + 1))


def decode_case(b, s, h, kh, d, positions, form=None, s_max=MAX_SEQ, seed=0,
                timed=True, **kw):
    """Kernel 2 in ``form`` on strided [:, :S] windows of a [B, S_max, K, D]
    cache layer, against its plain version, and twice on equal inputs
    (BITWISE equal: the splits are merged in split order).  Timed L2-cold
    with its device time, its bound and an SDPA yardstick over dequantized
    bf16 copies: the kernel rotates the layer over a stacked cache of
    ``cold_layers`` layers, the library call over copies of its inputs,
    each rotation larger than ``L2_COLD_BYTES``."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    layers = cold_layers(positions, s, kh, d, form) if timed else 1
    q, pos, view = decode_inputs(b, s, h, kh, d, positions, form, s_max,
                                 layers, seed)
    k_view, v_view, fkw = view(layers - 1)
    fkw.update(kw)
    got = da.flash_decode_attention(q, k_view, v_view, pos, **fkw)
    again = da.flash_decode_attention(q, k_view, v_view, pos, **fkw)
    want = da.plain(q, k_view, v_view, pos, **fkw)
    torch.cuda.synchronize()
    name = f"{row_name('flash_decode_attention', form)} S={s}"
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on equal inputs differ in "
                             f"{int(got.ne(again).sum())} values")
    win = kw.get("window") or (1 << 30)
    keys = torch.arange(s, device="cuda")[None, :]
    seen = ((keys <= pos[:, None]) & (pos[:, None] - keys < win)).any(-1)
    if (got[~seen] != 0).any():
        raise AssertionError(f"{name}: rows that see no key are not 0")
    err = check_close(name, got[seen], want[seen])
    if not timed:
        return err
    live = [min(p, s - 1) + 1 for p in positions]  # keys each slot attends
    nbytes = (2 * ELEM_BYTES[form] * sum(live) * kh * d
              + (2 * 4 * sum(live) * kh if form else 0)
              + 2 * 2 * b * h * d + 4 * b)
    flops = 4 * d * h * sum(live)
    views = [view(lay) for lay in range(layers)]  # the model slices per layer
    launch = rotating(lambda lay: da.flash_decode_attention(
        q, views[lay][0], views[lay][1], pos, **views[lay][2], **kw), layers)
    row = dict(
        shape=f"B{b} S{s} H{h} K{kh} D{d} parked{sum(p >= s for p in positions)} "
              f"L2-cold{layers}",
        max_abs_err=err,
        **kernel_ms(launch, iters=50),
        device_ms=device_ms(launch, "flash_decode_kernel"),
        plain_ms=timed_ms(lambda: da.plain(q, k_view, v_view, pos, **fkw))[0],
        **decode_library(q, view, s, pos, form, library_copies(
            2 * 2 * b * h * s * d, layers)),
    )
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


#: Kernel 4's decode view in phase 2: the engine's 512 bucket over a
#: 1024-position cache, 16 slots + scratch, one row parked at max_seq.
FUSED_VIEW = 512


def fused_inputs(h, kh, d, form, view, s_max, layers, seed, window=None,
                 softcap=None):
    """Kernel 4's inputs at the decode positions: (q, k_new, v_new, the
    cache leaves [k, v, k_scale, v_scale], positions, kwargs).  The step's
    rope table is built once per decode step on the main path
    (decode_step), not per layer, so it rides in the kwargs untimed."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd

    b = NUM_SLOTS + 1
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    q, kn, vn = rnd(b, h, d), rnd(b, kh, d), rnd(b, kh, d)
    kc, ks = cache_form(rnd(layers, b, s_max, kh, d), form, 2)
    vc, vs = cache_form(rnd(layers, b, s_max, kh, d), form, 2)
    pos = torch.tensor(decode_positions(b, view), dtype=torch.int32, device="cuda")
    kw = dict(kv_view=view, rope_theta=500000.0, kv_quant=form, window=window,
              softcap=softcap, rope=fd.rope_rows(pos, d, 500000.0))
    return q, kn, vn, [kc, vc, ks, vs], pos, kw


def fused_case(h, kh, d, form, view=FUSED_VIEW, s_max=MAX_SEQ, layers=2,
               window=None, softcap=None, seed=0, timed=True):
    """Kernel 4 in ``form`` on clones of one random cache: (a) against its
    plain version — attention within tolerance on the live rows, and the
    caches (values and scales) BIT-EXACT, which holds the appended bytes
    and scales; beyond that, only the live slots' own rows may change, an
    int4 append keeps its neighbour's nibble, and the parked row's cache
    and scales stay as they were; (b) a second launch on equal inputs —
    attention and caches BITWISE the first's.  Timed, the kernel and its
    library yardstick run L2-cold: the kernel rotates the layer over a
    stacked cache of ``cold_layers`` layers, the library call over two
    dequantized copies."""
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd

    b = NUM_SLOTS + 1
    positions = decode_positions(b, view)
    if timed:
        layers = cold_layers(positions, view, kh, d, form)
    q, kn, vn, orig, pos, kw = fused_inputs(h, kh, d, form, view, s_max,
                                            layers, seed, window, softcap)
    c1, c2, c3 = ([None if x is None else x.clone() for x in orig]
                  for _ in range(3))
    layer = layers - 1
    got = fd.fused_decode_layer(q, kn, vn, *c1, pos, layer, **kw)
    want = fd.plain(q, kn, vn, *c2, pos, layer, **kw)
    again = fd.fused_decode_layer(q, kn, vn, *c3, pos, layer, **kw)
    torch.cuda.synchronize()
    name = (f"{row_name('fused_decode_layer', form)} H{h} K{kh} D{d} "
            f"window {window} softcap {softcap}")
    live = [p < view for p in positions]
    err = check_close(name, got[live], want[live])
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on equal inputs differ in "
                             f"{int(got.ne(again).sum())} values")
    for ref, what in ((c2, "the plain version's"), (c3, "a second launch's")):
        for leaf, a, w in zip(("k", "v", "k_scale", "v_scale"), c1, ref):
            if a is not None and not torch.equal(a, w):
                raise AssertionError(f"{name}: cache leaf {leaf} differs from "
                                     f"{what} in {int(a.ne(w).sum())} entries")
    for leaf, a, o in zip(("k", "v", "k_scale", "v_scale"), c1, orig):
        if a is None:
            continue
        changed = a.ne(o)
        for slot, p in enumerate(positions):
            if p < view:
                row = p // 2 if (form == "int4" and leaf in ("k", "v")) else p
                changed[layer, slot, row] = False
        if changed.any():
            raise AssertionError(f"{name}: {leaf} changed outside the appended "
                                 f"rows (parked row or neighbours)")
        if form == "int4" and leaf in ("k", "v"):
            for slot, p in enumerate(positions):
                if p >= view:
                    continue
                new_b = a[layer, slot, p // 2].to(torch.int16) & 0xFF
                old_b = o[layer, slot, p // 2].to(torch.int16) & 0xFF
                keep = 0x0F if p % 2 else 0xF0  # the neighbour's nibble
                if not torch.equal(new_b & keep, old_b & keep):
                    raise AssertionError(f"{name}: int4 append at {p} "
                                         f"overwrote its neighbour's nibble")
    if not timed:
        return err
    del c3, orig
    keys = [min(p, view) for p in positions]  # cache keys each slot reads
    eb = ELEM_BYTES[form]
    n_live = sum(live)
    nbytes = (2 * eb * sum(keys) * kh * d + (2 * 4 * sum(keys) * kh if form else 0)
              + 2 * b * h * d * 2 + 2 * 2 * b * kh * d
              + n_live * (2 * eb * kh * d + (8 * kh if form else 0))
              + 4 * b)
    flops = 4 * d * h * (sum(keys) + b)
    launch = rotating(lambda lay: fd.fused_decode_layer(
        q, kn, vn, *c1, pos, lay, **kw), layers)
    row = dict(
        shape=f"B{b} view{view} S{s_max} H{h} K{kh} D{d} "
              f"parked{sum(p >= view for p in positions)} L2-cold{layers}",
        max_abs_err=err,
        **kernel_ms(launch, iters=50),
        device_ms=device_ms(launch, "fused_decode_layer_kernel"),
        plain_ms=timed_ms(lambda: fd.plain(q, kn, vn, *c2, pos, layer, **kw))[0],
    )
    rows = view // 2 if form == "int4" else view
    copies = []
    for lay in (0, 1):  # two dequantized copies, K and V ~143 MB each at llama3-8b
        kd, vd = c1[0][lay, :, :rows], c1[1][lay, :, :rows]
        if form is not None:
            kd = da.dequant_f32(kd, c1[2][lay, :, :view], form)
            vd = da.dequant_f32(vd, c1[3][lay, :, :view], form)
        copies.append([x.bfloat16().transpose(1, 2).repeat_interleave(h // kh, dim=1)
                       for x in (kd, vd)])
    qh = q[:, :, None, :]  # [B, H, 1, D]
    last = pos.long().clamp(max=view - 1)
    am = (torch.arange(view, device="cuda")[None, :] <= last[:, None])[:, None, None, :]
    row.update(library_times(rotating(
        lambda n: F.scaled_dot_product_attention(qh, *copies[n], attn_mask=am),
        2)))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


#: Kernel 5's burst width at the serve CLI's --spec-k 4 (K proposals + 1).
SPEC_T = 5
#: max |kernel 5 - T sequential kernel-4 launches| per kernel-table row,
#: over phase 2 (printed, held to the same tolerance as the plain version).
SEQ_DIFF: dict = {}


def spec_positions(b: int, view: int) -> list:
    """Burst row 0 per slot: bursts inside a 64-key tile and straddling a
    tile edge (60, 62, 63, 124), odd int4 starts (1, 63, 101, 255), one
    burst crossing ``view`` (view - 2: two live tokens, three parked) and
    one slot parked at max_seq."""
    act = [0, 1, 60, 62, 63, 64, 101, 124, 128, 200, 255, 256, 300, 401,
           view - 7, view - 2]
    return (act * b)[: b - 1] + [MAX_SEQ]


def spec_inputs(h, kh, d, form, t, view, s_max, layers, seed, window=None,
                softcap=None):
    """Kernel 5's inputs at the serving positions: (q, k_new, v_new, the
    cache leaves [k, v, k_scale, v_scale], positions, kwargs)."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import fused_spec_decode as fs

    b = NUM_SLOTS + 1
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    q, kn, vn = rnd(b, t, h, d), rnd(b, t, kh, d), rnd(b, t, kh, d)
    kc, ks = cache_form(rnd(layers, b, s_max, kh, d), form, 2)
    vc, vs = cache_form(rnd(layers, b, s_max, kh, d), form, 2)
    pos = torch.tensor(spec_positions(b, view), dtype=torch.int32, device="cuda")
    kw = dict(kv_view=view, rope_theta=500000.0, kv_quant=form, window=window,
              softcap=softcap, rope=fs.burst_rope_rows(pos, t, d, 500000.0))
    return q, kn, vn, [kc, vc, ks, vs], pos, kw


def spec_case(h, kh, d, form, t=SPEC_T, view=FUSED_VIEW, s_max=MAX_SEQ,
              layers=2, window=None, softcap=None, seed=0, timed=True):
    """Kernel 5 in ``form`` on clones of one random cache: (a) against its
    plain version — attention within tolerance on the live rows, caches
    (values and scales) BIT-EXACT, only the live tokens' rows changed, an
    int4 burst's neighbour nibbles and the parked row untouched; (b)
    against ``t`` sequential kernel-4 launches on the same inputs and rope
    rows — attention within the same tolerance (the max difference goes
    to ``SEQ_DIFF``), caches bit-exact; (c) a second launch on equal
    inputs — attention and caches BITWISE the first's.  Timed, the kernel
    and its library yardstick run L2-cold: the kernel rotates the layer
    over a stacked cache of ``cold_layers`` layers, the library call
    over two dequantized copies."""
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
    from p2p_llm_tunnel_tpu_torch.ops import fused_spec_decode as fs

    b = NUM_SLOTS + 1
    positions = spec_positions(b, view)
    if timed:
        layers = cold_layers(positions, view, kh, d, form)
    q, kn, vn, orig, pos, kw = spec_inputs(h, kh, d, form, t, view, s_max,
                                           layers, seed, window, softcap)
    c1, c2, c3, c4 = ([None if x is None else x.clone() for x in orig]
                      for _ in range(4))
    layer = layers - 1
    rope = kw["rope"]
    got = fs.fused_spec_decode_layer(q, kn, vn, *c1, pos, layer, **kw)
    want = fs.plain(q, kn, vn, *c2, pos, layer, **kw)
    seq = torch.stack([fd.fused_decode_layer(
        q[:, i].contiguous(), kn[:, i].contiguous(), vn[:, i].contiguous(),
        *c3, pos + i, layer, kv_view=view, rope_theta=500000.0,
        kv_quant=form, window=window, softcap=softcap,
        rope=(rope[0][:, i].contiguous(), rope[1][:, i].contiguous()))
        for i in range(t)], dim=1)
    again = fs.fused_spec_decode_layer(q, kn, vn, *c4, pos, layer, **kw)
    torch.cuda.synchronize()
    rname = row_name('fused_spec_decode_layer', form)
    name = f"{rname} T{t} H{h} K{kh} D{d} window {window} softcap {softcap}"
    live = (pos[:, None].long() + torch.arange(t, device="cuda")[None, :]) < view
    err = check_close(name, got[live], want[live])
    seq_err = check_close(name, got[live], seq[live],
                          ref=f"{t} sequential kernel-4 launches")
    SEQ_DIFF[rname] = max(SEQ_DIFF.get(rname, 0.0), seq_err)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on equal inputs differ in "
                             f"{int(got.ne(again).sum())} values")
    for ref, what in ((c2, "the plain version's"),
                      (c3, "the sequential kernel-4 launches'"),
                      (c4, "a second launch's")):
        for leaf, a, w in zip(("k", "v", "k_scale", "v_scale"), c1, ref):
            if a is not None and not torch.equal(a, w):
                raise AssertionError(f"{name}: cache leaf {leaf} differs from "
                                     f"{what} in {int(a.ne(w).sum())} entries")
    for leaf, a, o in zip(("k", "v", "k_scale", "v_scale"), c1, orig):
        if a is None:
            continue
        packed = form == "int4" and leaf in ("k", "v")
        changed = a.ne(o)
        for slot, p in enumerate(positions):
            for tok in range(p, min(p + t, view)):
                changed[layer, slot, tok // 2 if packed else tok] = False
        if changed.any():
            raise AssertionError(f"{name}: {leaf} changed outside the appended "
                                 f"rows (parked row or tokens)")
        if packed:
            for slot, p in enumerate(positions):
                end = min(p + t, view)
                if p >= view:
                    continue
                edges = []
                if p % 2:
                    edges.append((p // 2, 0x0F))  # the committed token before
                if end % 2:
                    edges.append((end // 2, 0xF0))  # the token after the burst
                for byte, keep in edges:
                    new_b = a[layer, slot, byte].to(torch.int16) & 0xFF
                    old_b = o[layer, slot, byte].to(torch.int16) & 0xFF
                    if not torch.equal(new_b & keep, old_b & keep):
                        raise AssertionError(f"{name}: burst at {p} overwrote a "
                                             f"neighbour's nibble in byte {byte}")
    if not timed:
        return err
    del c2, c3, c4, orig
    eb = ELEM_BYTES[form]
    cache_keys = sum(min(p, view) for p in positions)  # read from the cache
    n_live = int(live.sum())
    attended = sum(min(p + i, view) + 1 for p in positions for i in range(t))
    nbytes = (2 * eb * cache_keys * kh * d + (2 * 4 * cache_keys * kh if form else 0)
              + 2 * b * t * h * d * 2 + 2 * 2 * b * t * kh * d + 2 * 4 * b * t * d // 2
              + n_live * (2 * eb * kh * d + (8 * kh if form else 0)) + 4 * b)
    launch = rotating(lambda lay: fs.fused_spec_decode_layer(
        q, kn, vn, *c1, pos, lay, **kw), layers)
    row = dict(
        shape=f"B{b} T{t} view{view} S{s_max} H{h} K{kh} D{d} "
              f"parked{sum(p >= view for p in positions)} L2-cold{layers}",
        max_abs_err=err,
        **kernel_ms(launch, iters=50),
        device_ms=device_ms(launch, "fused_spec_kernel"),
        plain_ms=timed_ms(lambda: fs.plain(q, kn, vn, *c1, pos, layer, **kw),
                          iters=5)[0],
    )
    rows = view // 2 if form == "int4" else view
    copies = []
    for lay in (0, 1):  # two dequantized copies, K and V ~143 MB each at llama3-8b
        kd, vd = c1[0][lay, :, :rows], c1[1][lay, :, :rows]
        if form is not None:
            kd = da.dequant_f32(kd, c1[2][lay, :, :view], form)
            vd = da.dequant_f32(vd, c1[3][lay, :, :view], form)
        copies.append([x.bfloat16().transpose(1, 2).repeat_interleave(h // kh, dim=1)
                       for x in (kd, vd)])
    qh = q.transpose(1, 2)  # [B, H, T, D]
    at = pos.long()[:, None] + torch.arange(t, device="cuda")[None, :]  # [B, T]
    am = torch.arange(view, device="cuda")[None, None, :] <= at.clamp(max=view - 1)[:, :, None]
    am = am[:, None]  # causal T-row mask [B, 1, T, view]
    row.update(library_times(rotating(
        lambda i: F.scaled_dot_product_attention(qh, *copies[i], attn_mask=am),
        2)))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * d * h * attended)
    return row


def plane_case(b, s, h, kh, d, positions, s_max=MAX_SEQ, seed=0, timed=True, **kw):
    """Kernel 3 (raw) on strided [:, :S] windows of a [B, S_max, K, D]
    cache layer, against its plain version and against kernel 2 on the
    same inputs; timed L2-cold as kernel 2 is, with its device time, its
    bound and kernel 2's SDPA yardstick."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    layers = cold_layers(positions, s, kh, d, None) if timed else 1
    q, pos, view = decode_inputs(b, s, h, kh, d, positions, None, s_max,
                                 layers, seed)
    kc, vc, _ = view(layers - 1)
    got = da.flash_decode_attention_plane(q, kc, vc, pos, **kw)
    want = da.plain(q, kc, vc, pos, **kw)
    k2 = da.flash_decode_attention(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    win = kw.get("window") or (1 << 30)
    keys = torch.arange(s, device="cuda")[None, :]
    seen = ((keys <= pos[:, None]) & (pos[:, None] - keys < win)).any(-1)
    name = f"flash_decode_attention_plane S={s} H{h} K{kh} D{d} {kw}"
    err = max(check_close(name, got[seen], want[seen]),
              check_close(name + " vs kernel 2", got[seen], k2[seen]))
    if not timed:
        return err
    live = [min(p, s - 1) + 1 for p in positions]
    nbytes = 2 * 2 * sum(live) * kh * d + 2 * 2 * b * h * d + 4 * b
    views = [view(lay)[:2] for lay in range(layers)]
    launch = rotating(lambda lay: da.flash_decode_attention_plane(
        q, *views[lay], pos, **kw), layers)
    row = dict(
        shape=f"B{b} S{s} H{h} K{kh} D{d} parked{sum(p >= s for p in positions)} "
              f"L2-cold{layers}",
        max_abs_err=err,
        **kernel_ms(launch, iters=50),
        device_ms=device_ms(launch, "plane_decode_kernel"),
        plain_ms=timed_ms(lambda: da.plain(q, kc, vc, pos, **kw))[0],
        **decode_library(q, view, s, pos, None, library_copies(
            2 * 2 * b * h * s * d, layers)),
    )
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * d * h * sum(live))
    return row


def preset_checks() -> dict:
    """Correctness only, no timing: the kernels' other head-dim and
    grouping instances, at the head geometry of presets the port serves
    besides llama3-8b — gemma2-2b (D 256, GQA 8/4, window + softcap),
    llama3.2-1b (D 64), llama3-70b (G 8), qwen2-7b (G 7), tiny-gemma
    (D 16, window 8) — with a padded prompt, so under a window some pad
    rows see no key.  Returns the max
    |kernel - plain| per kernel."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def split_check(name, got, want, seen):
        """Rows that see at least one key match the plain version; rows
        that see none (a window past every valid key) return 0, as the
        TPU kernel's do — the plain version returns the mean of V there."""
        if (got[~seen] != 0).any():
            raise AssertionError(f"{name}: rows that see no key are not 0")
        return check_close(name, got[seen], want[seen])

    errs = {"flash_causal_attention": 0.0, "flash_decode_attention_plane": 0.0}
    errs.update({row_name(k, f): 0.0 for f in FORMS
                 for k in ("flash_decode_attention", "fused_decode_layer",
                           "fused_spec_decode_layer")})
    for preset, h, kh, d, window, softcap in (
        ("gemma2-2b", 8, 4, 256, 64, 50.0),
        ("llama3.2-1b", 32, 8, 64, None, None),
        ("llama3-70b", 64, 8, 128, None, None),
        ("qwen2-7b", 28, 4, 128, None, None),
        ("tiny-gemma", 4, 2, 16, 8, 50.0),
    ):
        kw = dict(window=window, softcap=softcap)
        win = window or (1 << 30)
        t = 200
        q, k, v = rnd(2, t, h, d), rnd(2, t, kh, d), rnd(2, t, kh, d)
        valid = torch.arange(t, device="cuda")[None, :] < torch.tensor(
            [[t], [77]], device="cuda")
        i = torch.arange(t, device="cuda")[:, None]
        j = torch.arange(t, device="cuda")[None, :]
        p_seen = (((j <= i) & (i - j < win))[None]
                  & valid[:, None, :]).any(-1)  # [B, T]
        e_p = split_check(f"flash_causal_attention {preset}",
                          fa.flash_causal_attention(q, k, v, valid, **kw),
                          fa.plain(q, k, v, valid, **kw), p_seen)
        q1, kc, vc = rnd(5, 1, h, d), rnd(5, 256, kh, d), rnd(5, 256, kh, d)
        pos = torch.tensor([0, 63, 64, 200, MAX_SEQ], dtype=torch.int32,
                           device="cuda")
        keys = torch.arange(256, device="cuda")[None, :]
        d_seen = ((keys <= pos[:, None]) & (pos[:, None] - keys < win)).any(-1)
        e_d = split_check(f"flash_decode_attention {preset}",
                          da.flash_decode_attention(q1, kc, vc, pos, **kw),
                          da.plain(q1, kc, vc, pos, **kw), d_seen)
        print(f"[kernels] {preset} heads {h}/{kh} D {d} window {window} "
              f"softcap {softcap}: max|err| prefill {e_p:.3e} decode "
              f"{e_d:.3e}; rows that see no key, all 0: prefill "
              f"{int((~p_seen).sum())}, decode {int((~d_seen).sum())}")
        errs["flash_causal_attention"] = max(errs["flash_causal_attention"], e_p)
        errs["flash_decode_attention"] = max(errs["flash_decode_attention"], e_d)
        more = {}
        for form in ("int8", "int4"):
            more[row_name("flash_decode_attention", form)] = decode_case(
                5, 256, h, kh, d, [0, 63, 64, 200, MAX_SEQ], form=form,
                s_max=256, seed=5, timed=False, **kw)
        for form in FORMS:
            more[row_name("fused_decode_layer", form)] = fused_case(
                h, kh, d, form, view=256, s_max=512, layers=1, seed=6,
                timed=False, **kw)
        for form in FORMS:
            more[row_name("fused_spec_decode_layer", form)] = spec_case(
                h, kh, d, form, view=256, s_max=512, layers=1, seed=7,
                timed=False, **kw)
        more["flash_decode_attention_plane"] = plane_case(
            5, 256, h, kh, d, [0, 63, 64, 200, MAX_SEQ], s_max=256, seed=8,
            timed=False, **kw)
        print(f"[kernels] {preset} quantized decode, fused layer, verify burst "
              f"and plane kernel, max|err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in more.items())
              + "; caches bit-exact, verify bursts within tolerance of sequential "
              "kernel 4 and bitwise run to run")
        for k, v in more.items():
            errs[k] = max(errs[k], v)
    return errs


#: The ragged kernel's serving group: 8 rows of (history, tail) with
#: histories {0, 16, 128, 368, 512} and tails that end mid-block, flat
#: bucket TOT 1024 = prefill_rows 8 x prefill_chunk 128 (the mux default).
RAGGED_ROWS = [(0, 100), (16, 37), (128, 128), (368, 77), (512, 5), (0, 120),
               (128, 63), (368, 99)]
RAGGED_TOT = 1024


def ragged_group(h, kh, d, rows, tot, s=MAX_SEQ, slots=NUM_SLOTS + 1,
                 window=None, softcap=None, seed=0, layers=2, form=None,
                 copies=1, block_q=16):
    """Run the ragged kernel and its plain version in ``form`` on copies of
    the same random cache; check the real rows' attention and every
    non-scratch cache row (raw: within tolerance; quantized: values and
    scales bit-exact).  Returns the inputs and ``run(n)``, the kernel on
    layer ``n % layers`` with input set ``n % copies`` (``copies`` sets of
    q / k_new / v_new), for timing."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa

    entries = [(i, st, ln) for i, (st, ln) in enumerate(rows)]
    slot_of, start_of, qoff_of, _qlen, base_of, offs = pa.plan_ragged_group(
        entries, block_q, tot, scratch_slot=slots - 1)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    ins = [(rnd(tot, h, d), rnd(tot, kh, d), rnd(tot, kh, d)) for _ in range(copies)]
    kc, ks = cache_form(rnd(layers, slots, s, kh, d), form, 2)
    vc, vs = cache_form(rnd(layers, slots, s, kh, d), form, 2)
    descs = [torch.tensor(x, device="cuda") for x in (slot_of, start_of, qoff_of, base_of)]
    kw = dict(block_q=block_q, rope_theta=500000.0, window=window, softcap=softcap)
    if form is not None:
        kw["kv_quant"] = form
    layer = layers - 1
    c1 = [None if x is None else x.clone() for x in (kc, vc, ks, vs)]
    c2 = [None if x is None else x.clone() for x in (kc, vc, ks, vs)]

    def run(fn, c, n=0, lay=layer):
        return fn(*ins[n], c[0], c[1], *descs, lay, k_scale=c[2],
                  v_scale=c[3], **kw)

    got = run(pa.ragged_prefill_attention, c1)
    want = run(pa.plain, c2)
    torch.cuda.synchronize()
    name = (f"{row_name('ragged_prefill_attention', form)} H{h} K{kh} D{d} "
            f"window {window} softcap {softcap}")
    real = torch.cat([torch.arange(o, o + ln, device="cuda")
                      for (_, _, ln), o in zip(entries, offs)])
    err = check_close(name, got[real], want[real])
    if form is None:
        err = max([err] + [check_close(name + " cache", a[:, :-1], b[:, :-1])
                           for a, b in zip(c1[:2], c2[:2])])
    else:
        for leaf, a, b in zip(("k", "v", "k_scale", "v_scale"), c1, c2):
            if not torch.equal(a[:, :-1], b[:, :-1]):
                raise AssertionError(
                    f"{name}: cache leaf {leaf} differs from the plain "
                    f"version's in {int(a[:, :-1].ne(b[:, :-1]).sum())} entries")
    return dict(entries=entries, offs=offs, err=err,
                run=lambda n=0: run(pa.ragged_prefill_attention, c1,
                                    n % copies, n % layers),
                run_plain=lambda: run(pa.plain, c2),
                ins=ins, cache=c1, layers=layers)


def ragged_library(c, h, kh, form):
    """The kernel-6 yardstick, L2-cold: scaled_dot_product_attention with
    an explicit boolean mask over the group's rows padded to [rows, H,
    tail, start + tail], over dequantized bf16 copies of the cache (no
    rope, no quantization, no append; the port never calls it), rotating
    over copies built from the kernel's input sets and layers."""
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    rows = len(c["entries"])
    d = c["ins"][0][0].shape[2]
    t_max = max(ln for _, _, ln in c["entries"])
    s_max = max(st + ln for _, st, ln in c["entries"])
    copy_bytes = 2 * rows * h * d * (t_max + 2 * s_max)
    n_copies = library_copies(copy_bytes, min(c["layers"], len(c["ins"])))
    kc, vc, ks, vs = c["cache"]
    mask = torch.zeros((rows, 1, t_max, s_max), dtype=torch.bool, device="cuda")
    for r, (_slot, st, ln) in enumerate(c["entries"]):
        i = torch.arange(ln, device="cuda")[:, None]
        j = torch.arange(s_max, device="cuda")[None, :]
        mask[r, 0, :ln] = j <= st + i
    copies = []
    for n in range(n_copies):
        qp = torch.zeros((rows, h, t_max, d), dtype=torch.bfloat16, device="cuda")
        kp = torch.zeros((rows, h, s_max, d), dtype=torch.bfloat16, device="cuda")
        vp = torch.zeros_like(kp)
        for r, ((slot, st, ln), off) in enumerate(zip(c["entries"], c["offs"])):
            qp[r, :, :ln] = c["ins"][n][0][off:off + ln].transpose(0, 1)
            for dst, src, sc in ((kp, kc, ks), (vp, vc, vs)):
                plane = src[n, slot][None]
                if form is not None:
                    plane = da.dequant_f32(plane, sc[n, slot][None], form)
                dst[r, :, :st + ln] = plane[0, :st + ln].bfloat16().transpose(
                    0, 1).repeat_interleave(h // kh, dim=0)
        copies.append((qp, kp, vp))
    return library_times(rotating(lambda n: F.scaled_dot_product_attention(
        *copies[n], attn_mask=mask), n_copies), iters=20)


def ragged_case(h, kh, d, form=None):
    """The serving group shape, timed L2-cold: the kernel rotates the layer
    over a stacked cache and the input set over as many copies of q /
    k_new / v_new, each rotation's history and inputs larger than
    ``L2_COLD_BYTES``; with its device time, the plain version, and the
    attention-only yardstick of :func:`ragged_library`."""
    real = sum(ln for _, ln in RAGGED_ROWS)
    pairs = sum(st * ln + ln * (ln + 1) // 2 for st, ln in RAGGED_ROWS)
    hist = sum(st for st, _ in RAGGED_ROWS)
    eb = ELEM_BYTES[form]
    # q + out (bf16), k_new + v_new (bf16), the appended K/V in the cache's
    # form, and the history each row reads, each once; scales beside
    # quantized rows.
    nbytes = (2 * real * 2 * h * d + 2 * real * 2 * kh * d
              + (real + hist) * kh * d * 2 * eb
              + ((real + hist) * kh * 8 if form else 0))
    per_set = (2 * RAGGED_TOT * (h + 2 * kh) * d
               + hist * kh * (2 * d * eb + (8 if form else 0)))
    sets = max(2, -(-int(L2_COLD_BYTES) // int(per_set)) + 1)
    c = ragged_group(h, kh, d, RAGGED_ROWS, RAGGED_TOT, form=form,
                     layers=sets, copies=sets)
    launch = rotating(c["run"], sets)
    library = ragged_library(c, h, kh, form)
    row = dict(
        shape=f"rows{len(RAGGED_ROWS)} TOT{RAGGED_TOT} BQ16 H{h} K{kh} D{d} "
              f"hist{sorted({st for st, _ in RAGGED_ROWS})} L2-cold{sets}",
        max_abs_err=c["err"],
        **kernel_ms(launch),
        device_ms=device_ms(launch, "ragged_prefill_kernel"),
        plain_ms=timed_ms(c["run_plain"], iters=5)[0],
        **library,
    )
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * h * d * pairs)
    return row


def ragged_preset_checks() -> dict:
    """Untimed: the ragged kernel's other head-dim and grouping instances,
    in every KV form, at the presets' head geometry (gemma2-2b with window
    64 + softcap 50, llama3.2-1b D 64, llama3-70b G 8, qwen2-7b G 7,
    tiny-gemma D 16 with window 8 + softcap 50).  Returns the max
    |kernel - plain| per form's row."""
    worst = {row_name("ragged_prefill_attention", f): 0.0 for f in FORMS}
    rows = [(0, 40), (32, 17), (96, 64)]
    for preset, h, kh, d, window, softcap in (
        ("gemma2-2b", 8, 4, 256, 64, 50.0),
        ("llama3.2-1b", 32, 8, 64, None, None),
        ("llama3-70b", 64, 8, 128, None, None),
        ("qwen2-7b", 28, 4, 128, None, None),
        ("tiny-gemma", 4, 2, 16, 8, 50.0),
    ):
        errs = {}
        for form in FORMS:
            c = ragged_group(h, kh, d, rows, 160, s=256, slots=5, window=window,
                             softcap=softcap, seed=4, layers=1, form=form)
            errs[row_name("ragged_prefill_attention", form)] = c["err"]
        print(f"[kernels] ragged {preset} heads {h}/{kh} D {d} window "
              f"{window} softcap {softcap}: max|err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    # The engine's other q-block widths (a power of two >= 8 dividing its
    # buckets): query tiles of 1-8 q-blocks, rows ending mid-warp.
    for h, kh, d, bq in ((8, 4, 32, 8), (16, 8, 64, 8), (32, 8, 128, 32)):
        for form in FORMS:
            c = ragged_group(h, kh, d, rows, 160, s=256, slots=5, seed=5,
                             layers=1, form=form, block_q=bq, window=48)
            name = row_name("ragged_prefill_attention", form)
            worst[name] = max(worst[name], c["err"])
        print(f"[kernels] ragged heads {h}/{kh} D {d} block_q {bq} window 48: "
              f"every form within tolerance, caches checked")
    return worst


def decode_positions(b: int, s: int) -> list:
    """Active slots spread over 64/128/256-key block edges, plus one slot
    parked at max_seq as the engine parks idle rows."""
    edges = [0, 1, 63, 64, 65, 127, 128, 255, 256, 257, 511, 512, 767, 1000,
             s - 2, s - 1]
    act = sorted({min(p, s - 1) for p in edges})
    act = (act * b)[: b - 1]
    return act + [MAX_SEQ]


def kernel_phase(cfg) -> dict:
    """Every (kernel, KV form) row at the main path's shapes, timed."""
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = {"flash_causal_attention": []}
    for t in (128, 200, 256, 512):
        rows["flash_causal_attention"].append(prefill_case(8, t, h, kh, d, [t] * 8))
    rows["flash_causal_attention"].append(prefill_case(
        8, 512, h, kh, d, [512] * 8, window=128, softcap=30.0, seed=1))
    rows["flash_causal_attention"].append(prefill_case(
        8, 512, h, kh, d, [512, 300, 17, 128, 129, 1, 450, 64], seed=2))
    b = NUM_SLOTS + 1  # the engine's rows: every slot plus the scratch row
    for form in FORMS:
        rows[row_name("flash_decode_attention", form)] = [
            decode_case(b, s, h, kh, d, decode_positions(b, s), form=form)
            for s in ((128, 256, 512, 1024) if form is None else (512,))]
    rows["flash_decode_attention_plane"] = [
        plane_case(b, 512, h, kh, d, decode_positions(b, 512))]
    for form in FORMS:
        rows[row_name("fused_decode_layer", form)] = [fused_case(h, kh, d, form)]
    for form in FORMS:
        # The serving burst (--spec-k 4; the JSON row) and the widest burst
        # of --spec-k-max 8 (T 9), both L2-cold.
        rows[row_name("fused_spec_decode_layer", form)] = [
            spec_case(h, kh, d, form), spec_case(h, kh, d, form, t=9, seed=1)]
    for form in FORMS:
        rows[row_name("ragged_prefill_attention", form)] = [ragged_case(h, kh, d, form)]
    for name, cases in rows.items():
        print(f"[kernels] {name} (bf16 activations, fp32 math; tolerance "
              f"{ATOL} + {RTOL}*|ref|; quantized caches bit-exact)")
        for r in cases:
            lib = ("n/a" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f})")
            dev = f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else ""
            print(f"  {r['shape']:<40} max|err| {r['max_abs_err']:.3e}  "
                  f"kernel {r['ms']:.4f} ms (spread {r['ms_spread']:.4f}){dev}  plain {r['plain_ms']:.4f} ms  "
                  f"library {lib} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def _kernels() -> dict:
    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import (
        flash_decode_attention,
        flash_decode_attention_plane,
    )
    from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
    from p2p_llm_tunnel_tpu_torch.ops.fused_decode import fused_decode_layer
    from p2p_llm_tunnel_tpu_torch.ops.fused_spec_decode import fused_spec_decode_layer
    from p2p_llm_tunnel_tpu_torch.ops.prefill_attention import ragged_prefill_attention

    return {"flash_causal_attention": flash_causal_attention,
            "flash_decode_attention": flash_decode_attention,
            "flash_decode_attention_plane": flash_decode_attention_plane,
            "fused_decode_layer": fused_decode_layer,
            "fused_spec_decode_layer": fused_spec_decode_layer,
            "ragged_prefill_attention": ragged_prefill_attention}


def reset_counters() -> None:
    """Zero every wrapper's launch counters (total and per KV form)."""
    for fn in _kernels().values():
        fn.launches = 0
        for key in getattr(fn, "form_launches", {}):
            fn.form_launches[key] = 0


def read_counters() -> dict:
    """Launches since the last reset, per kernel-table row."""
    out = {}
    for kname, fn in _kernels().items():
        if not hasattr(fn, "form_launches"):
            out[kname] = fn.launches
            continue
        for form in FORMS:
            out[row_name(kname, form)] = fn.form_launches[form or "none"]
    return out


def engine_form(engine):
    return None if engine.ecfg.kv_quant in ("none", "") else engine.ecfg.kv_quant


def check_engine_launches(engine, launches: dict, steps: int,
                          dispatches: int, spec: int = 0) -> None:
    """The engine's decode kernel in its KV form launched once per layer
    per decode step and the other decode kernel never; with speculation on
    the fused layer, the verify kernel (kernel 5) in that form once per
    layer per verify burst (never when unfused: the chunk path verifies);
    with ragged prefill the ragged kernel in that form once per layer per
    ragged dispatch.  Kernel 3 never launches on a serving path."""
    n_layers = engine.mcfg.n_layers
    form = engine_form(engine)
    fused = engine.mcfg.fused_decode_layer
    dec, other = (("fused_decode_layer", "flash_decode_attention") if fused
                  else ("flash_decode_attention", "fused_decode_layer"))
    if (steps == 0 and spec == 0) or launches[row_name(dec, form)] != n_layers * steps:
        raise AssertionError(
            f"{row_name(dec, form)} launches {launches[row_name(dec, form)]} "
            f"!= {n_layers} x {steps} decode steps")
    want_spec = n_layers * spec if fused else 0
    for f in FORMS:
        got = launches[row_name("fused_spec_decode_layer", f)]
        if got != (want_spec if f == form else 0):
            raise AssertionError(
                f"{row_name('fused_spec_decode_layer', f)} launches {got} on an "
                f"engine with {spec} verify bursts (fused {fused}, form {form})")
    if launches["flash_decode_attention_plane"]:
        raise AssertionError("kernel 3 launched on a serving path")
    if any(launches[row_name(other, f)] for f in FORMS):
        raise AssertionError(f"{other} launched on an engine that decodes "
                             f"with {dec}: {launches}")
    rag = row_name("ragged_prefill_attention", form)
    if engine.ecfg.ragged_prefill:
        if dispatches == 0 or launches[rag] != n_layers * dispatches:
            raise AssertionError(f"{rag} launches {launches[rag]} != "
                                 f"{n_layers} x {dispatches} ragged dispatches")


# ---------------------------------------------------------------------------
# phase 3: the serving path through the tunnel
# ---------------------------------------------------------------------------

async def _stream(base: str, i: int, max_tokens: int, prompt: str):
    from p2p_llm_tunnel_tpu_torch.endpoints import http11

    sse = i % 2 == 0
    if sse:
        path = "/v1/chat/completions"
        body = {"messages": [{"role": "user", "content": prompt}],
                "max_tokens": max_tokens, "stream": True, "ignore_eos": True}
    else:
        path = "/api/generate"
        body = {"prompt": prompt, "max_new_tokens": max_tokens,
                "ignore_eos": True}
    t0 = time.monotonic()
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=600.0,
    )
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}")
    buf, tokens, ttft, finish = b"", 0, None, None
    sep = b"\n\n" if sse else b"\n"
    async for chunk in resp.iter_chunks():
        buf += chunk
        while sep in buf:
            line, buf = buf.split(sep, 1)
            line = line.strip()
            if not line:
                continue
            if sse:
                data = line[len(b"data: "):]
                if data == b"[DONE]":
                    continue
                obj = json.loads(data)
                choice = obj["choices"][0]
                if choice["delta"].get("content"):
                    tokens += 1
                    ttft = ttft or time.monotonic() - t0
                finish = choice.get("finish_reason") or finish
            else:
                obj = json.loads(line)
                if obj.get("response"):
                    tokens += 1
                    ttft = ttft or time.monotonic() - t0
                if obj.get("done"):
                    finish = obj.get("done_reason")
    return dict(kind="sse" if sse else "ndjson", tokens=tokens, ttft=ttft,
                finish=finish, seconds=time.monotonic() - t0)


async def serve_phase(engine, n_requests: int, max_tokens: int) -> dict:
    """Concurrent streams through the tunnel (SSE chat and NDJSON generate
    alternating, prompts of 120-400 bytes) on one engine (phases 3 and
    6c); checks every stream finished and each kernel of the engine's path
    launched once per layer per prefill wave, decode step or ragged
    dispatch."""
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

    waves, steps, dispatches, spec = [0], [0], [0], [0]
    dispatch_prefill, decode_fn, ragged_rows, dispatch_spec = (
        engine._dispatch_prefill_batch, engine._decode_fn,
        engine._dispatch_ragged_rows, engine._dispatch_spec)

    def counted_prefill(*a, **kw):
        waves[0] += 1
        return dispatch_prefill(*a, **kw)

    def counted_decode(*a, **kw):
        steps[0] += a[5]  # (ov_mask, ov_tok, ov_pos, samp, view, steps)
        return decode_fn(*a, **kw)

    def counted_ragged(rows):
        dispatches[0] += 1
        return ragged_rows(rows)

    def counted_spec(**kw):
        spec[0] += 1
        return dispatch_spec(**kw)

    engine._dispatch_prefill_batch = counted_prefill
    engine._decode_fn = counted_decode
    engine._dispatch_ragged_rows = counted_ragged
    engine._dispatch_spec = counted_spec

    serve_ch, proxy_ch = loopback_pair()
    ready = asyncio.get_running_loop().create_future()
    serve_task = asyncio.create_task(
        run_serve(serve_ch, backend=engine_backend(engine, MODEL)))
    proxy_task = asyncio.create_task(
        run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))
    try:
        port = await asyncio.wait_for(ready, 30.0)
        base = f"http://127.0.0.1:{port}"
        prompts = [
            (f"Request {i}: summarise the tunnel design. " * (4 + 3 * i))[: 120 + 40 * i]
            for i in range(n_requests)
        ]
        reset_counters()
        t0 = time.monotonic()
        results = await asyncio.gather(*[
            _stream(base, i, max_tokens, p) for i, p in enumerate(prompts)
        ])
        wall = time.monotonic() - t0
        launches = read_counters()
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        serve_ch.close()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        engine._dispatch_prefill_batch = dispatch_prefill
        engine._decode_fn = decode_fn
        engine._dispatch_ragged_rows = ragged_rows
        engine._dispatch_spec = dispatch_spec
    for r in results:
        if r["tokens"] != max_tokens or r["finish"] != "length":
            raise AssertionError(f"stream ended early: {r}")
    n_layers = engine.mcfg.n_layers
    if engine.device.type == "cuda":
        # Under mux whole-prompt waves are only the echo route: none here.
        if (launches["flash_causal_attention"] != n_layers * waves[0]
                or (waves[0] == 0 and not engine.ecfg.mux)):
            raise AssertionError(
                f"prefill kernel launches {launches['flash_causal_attention']}"
                f" != {n_layers} x {waves[0]} prefill waves")
        check_engine_launches(engine, launches, steps[0], dispatches[0], spec[0])
    ttfts = [r["ttft"] for r in results]
    return dict(results=results, wall=wall, launches=launches,
                waves=waves[0], steps=steps[0], dispatches=dispatches[0],
                spec=spec[0],
                tok_s=sum(r["tokens"] for r in results) / wall,
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                ttft_max_ms=max(ttfts) * 1e3)


async def profile_phase(engine, n_requests: int, max_tokens: int) -> dict:
    """``--profile``: the engine with every slot busy, under
    torch.profiler — device busy time by kernel over the window, and the
    wall time per decode step (host clock around work that ends in a
    synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps, spec = [0], [0]
    decode_fn, dispatch_spec = engine._decode_fn, engine._dispatch_spec

    def counted_decode(*a, **kw):
        steps[0] += a[5]
        return decode_fn(*a, **kw)

    def counted_spec(**kw):
        spec[0] += 1
        return dispatch_spec(**kw)

    async def one(i):
        prompt = [(7 * i + j) % 250 + 1 for j in range(96 + 24 * i)]
        return sum([1 async for _ in engine.generate(
            prompt, max_new_tokens=max_tokens, stop_ids=())])

    engine._decode_fn = counted_decode
    engine._dispatch_spec = counted_spec
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            tokens = sum(await asyncio.gather(
                *[one(i) for i in range(n_requests)]))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        engine._decode_fn = decode_fn
        engine._dispatch_spec = dispatch_spec

    kernels = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    # The top 14, and the port's own kernels wherever they rank.
    shown = [e for i, e in enumerate(kernels)
             if i < 14 or any(n in e.key for n in PORT_KERNEL_NAMES)]
    return dict(wall_s=wall, tokens=tokens, steps=steps[0], spec=spec[0],
                busy_ms=busy_ms, busy_share=busy_ms / (wall * 1e3),
                top=[(e.key[:70], e.count, dev_us(e) / 1e3) for e in shown])


def print_profile(tag: str, pr: dict, name: str) -> None:
    import torch

    n = pr["steps"] + pr["spec"]
    print(f"{tag} {NUM_SLOTS} streams x {MAX_TOKENS} tokens: "
          f"{pr['tokens']} tokens, {pr['steps']} decode steps and "
          f"{pr['spec']} verify bursts in "
          f"{pr['wall_s']:.3f} s ({pr['tokens'] / pr['wall_s']:.1f} "
          f"tok/s, {pr['wall_s'] * 1e3 / max(n, 1):.2f} ms "
          f"per step or burst incl. prefill); device busy {pr['busy_ms']:.1f} ms "
          f"= {100 * pr['busy_share']:.1f}% of the window ({name}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for key, count, ms in pr["top"]:
        print(f"{tag}   {ms:9.2f} ms  {count:6d}x  {key}")


# ---------------------------------------------------------------------------
# phase 4: logits through the kernel path and the plain path
# ---------------------------------------------------------------------------

def logits_phase(cfg, params, prompt_len: int = 200, forced: int = 4,
                 quant=None, fused: bool = False) -> dict:
    """One prompt's prefill and ``forced`` teacher-forced decode steps
    through the kernel path and through the plain path (every kernel
    wrapper swapped for its plain version) on the same weights, with a
    ``quant`` KV cache and the unfused or fused decode layer."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd

    cfg = dataclasses.replace(cfg, fused_decode_layer=fused)
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, 256, (1, prompt_len), generator=g, device=dev)
    forced_toks = torch.randint(0, 256, (forced,), generator=g, device=dev)

    def run():
        cache = tr.init_kv_cache(cfg, 1, 512, dtype=params["embed"].dtype,
                                 quant=quant, device=dev)
        lengths = torch.tensor([prompt_len], device=dev)
        slots = torch.tensor([0], device=dev)
        last, _ = tr.prefill_into_cache(cfg, params, toks, lengths, cache, slots)
        out = [last[0]]
        for n in range(forced):
            pos = torch.tensor([prompt_len + n], dtype=torch.int32, device=dev)
            logits, _ = tr.decode_step(cfg, params, cache, forced_toks[n:n + 1],
                                       pos, kv_view=256 if prompt_len + n < 256 else 512)
            out.append(logits[0])
        return torch.stack(out)

    swaps = {"flash_causal_attention": fa.plain, "flash_decode_attention": da.plain,
             "fused_decode_layer": fd.plain}
    with torch.inference_mode():
        kernel = run()
        saved = {name: getattr(tr, name) for name in swaps}
        for name, fn in swaps.items():
            setattr(tr, name, fn)
        try:
            plain = run()
        finally:
            for name, fn in saved.items():
                setattr(tr, name, fn)
    if not torch.isfinite(kernel).all():
        raise AssertionError("kernel-path logits are not finite")
    diff = (kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # bf16 activations through 32 layers: each attention output differs by
    # bf16 rounding; bound the drift at 5% of the logits' range.
    limit = 0.05 * scale
    if diff > limit:
        raise AssertionError(
            f"kernel-path logits drift {diff:.4g} > {limit:.4g} from the plain "
            f"path (kv_quant {quant}, fused {fused})")
    return dict(max_abs_diff=diff, logit_scale=scale, limit=limit,
                argmax_agree=agree, rows=forced + 1, quant=quant, fused=fused)


def spec_logits_phase(cfg, params, prompt_len: int = 200, t: int = SPEC_T) -> dict:
    """The verify burst at model level on the int4 cache with the fused
    layers: ``spec_verify_into_cache`` over the first token and the greedy
    tokens of ``t - 1`` sequential ``decode_step``s, against those ``t``
    steps' logits: within the phase's 5% bound, with argmax agreement at
    least 0.8; the cache bytes that differ are reported, not required
    (kernel 5 and kernel 4 sum in another order, so a layer's output, and
    the next layer's K/V, differ within tolerance)."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    cfg = dataclasses.replace(cfg, fused_decode_layer=True)
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, 256, (1, prompt_len), generator=g, device=dev)
    with torch.inference_mode():
        cache = tr.init_kv_cache(cfg, 1, 512, dtype=params["embed"].dtype,
                                 quant="int4", device=dev)
        last, _ = tr.prefill_into_cache(cfg, params, toks,
                                        torch.tensor([prompt_len], device=dev),
                                        cache, torch.tensor([0], device=dev))
        seq_cache = {k: v.clone() for k, v in cache.items()}
        tok = last.argmax(-1)
        burst, seq = [tok], []
        for n in range(t):
            pos = torch.tensor([prompt_len + n], dtype=torch.int32, device=dev)
            logits, _ = tr.decode_step(cfg, params, seq_cache, burst[-1], pos,
                                       kv_view=256)
            seq.append(logits[0])
            if n < t - 1:
                burst.append(logits.argmax(-1))
        seq = torch.stack(seq)
        logits, _ = tr.spec_verify_into_cache(
            cfg, params, torch.stack(burst, dim=1),
            torch.tensor([prompt_len], dtype=torch.int32, device=dev), cache,
            kv_view=256)
        logits = logits[0]
    if not torch.isfinite(logits).all():
        raise AssertionError("verify-burst logits are not finite")
    diff = (logits - seq).abs().max().item()
    limit = 0.05 * seq.abs().max().item()
    agree = (logits.argmax(-1) == seq.argmax(-1)).float().mean().item()
    if diff > limit or agree < 0.8:
        raise AssertionError(f"verify-burst logits drift {diff:.4g} (limit "
                             f"{limit:.4g}), argmax agreement {agree:.2f} (at "
                             f"least 0.8) against {t} sequential decode steps")
    mismatch = {k: int(cache[k].ne(seq_cache[k]).sum()) for k in cache}
    return dict(max_abs_diff=diff, limit=limit, rows=t, argmax_agree=agree,
                cache_mismatch=mismatch,
                cache_entries={k: cache[k].numel() for k in cache})


# ---------------------------------------------------------------------------
# phase 5: the serve CLI's default engine (mux + prefix pool + conversation
# cache) with ragged prefill, two-turn conversations through the tunnel
# ---------------------------------------------------------------------------

async def _conv_turn(base: str, prompt_ids, max_tokens: int, ndjson: bool):
    """One streamed turn; NumericTokenizer renders each id as ``"<id> "``,
    so the answer's ids come back exactly."""
    from p2p_llm_tunnel_tpu_torch.endpoints import http11

    if ndjson:
        path, sep = "/api/generate", b"\n"
        body = {"prompt": bytes(prompt_ids).decode("ascii"),
                "max_new_tokens": max_tokens, "ignore_eos": True}
    else:
        path, sep = "/v1/completions", b"\n\n"
        body = {"prompt": list(prompt_ids), "max_tokens": max_tokens,
                "stream": True, "ignore_eos": True}
    t0 = time.monotonic()
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=600.0,
    )
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}")
    buf, text, ttft, finish = b"", "", None, None
    async for chunk in resp.iter_chunks():
        buf += chunk
        while sep in buf:
            line, buf = buf.split(sep, 1)
            line = line.strip()
            if not line or line == b"data: [DONE]":
                continue
            if ndjson:
                obj = json.loads(line)
                piece, done = obj.get("response", ""), obj.get("done_reason")
            else:
                choice = json.loads(line[len(b"data: "):])["choices"][0]
                piece, done = choice.get("text") or "", choice.get("finish_reason")
            if piece:
                text += piece
                ttft = ttft or time.monotonic() - t0
            finish = done or finish
    return dict(kind="ndjson" if ndjson else "sse",
                ids=[int(t) for t in text.split()], ttft=ttft, finish=finish,
                seconds=time.monotonic() - t0)


async def mux_phase(engine) -> dict:
    """8 two-turn conversations through the tunnel on a mux engine (phases
    5 and 6); the kernel checks follow the engine's KV form, decode kernel
    and ragged switch."""
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    dispatches, steps, spec, hist_of = [0], [0], [0], {}
    ragged_rows, decode_fn, match, dispatch_spec = (
        engine._dispatch_ragged_rows, engine._decode_fn, engine._prefix.match,
        engine._dispatch_spec)

    def counted_ragged(rows):
        dispatches[0] += 1
        return ragged_rows(rows)

    def counted_decode(*a, **kw):
        steps[0] += a[5]
        return decode_fn(*a, **kw)

    def recorded_match(prompt_ids):
        hist, ids = match(prompt_ids)
        key = tuple(prompt_ids)
        hist_of[key] = max(hist_of.get(key, 0), hist)
        return hist, ids

    def counted_spec(**kw):
        spec[0] += 1
        return dispatch_spec(**kw)

    engine._dispatch_ragged_rows = counted_ragged
    engine._decode_fn = counted_decode
    engine._prefix.match = recorded_match
    engine._dispatch_spec = counted_spec
    counters = ("engine_prefix_hit_tokens_total",
                "engine_prefix_dedup_hits_total",
                "engine_conv_saved_pages_total", "engine_conv_hits_total",
                "engine_spec_proposed_tokens_total",
                "engine_spec_accepted_tokens_total")
    system = list(SYSTEM_PROMPT.encode())
    firsts = [system + list(f"Turn one of conversation {i}: how does the "
                            f"tunnel carry request {i}? ".encode() * (1 + i % 2))
              for i in range(N_CONV)]
    serve_ch, proxy_ch = loopback_pair()
    ready = asyncio.get_running_loop().create_future()
    serve_task = asyncio.create_task(
        run_serve(serve_ch, backend=engine_backend(engine, MODEL)))
    proxy_task = asyncio.create_task(
        run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))
    try:
        base = f"http://127.0.0.1:{await asyncio.wait_for(ready, 30.0)}"
        before = {c: global_metrics.counter(c) for c in counters}
        reset_counters()
        t0 = time.monotonic()
        one = await asyncio.gather(*[
            _conv_turn(base, p, TURN1_TOKENS, ndjson=i % 2 == 1)
            for i, p in enumerate(firsts)])
        seconds = [p + r["ids"] + list(b" And what happens next?")
                   for p, r in zip(firsts, one)]
        two = await asyncio.gather(*[
            _conv_turn(base, p, TURN2_TOKENS, ndjson=False) for p in seconds])
        wall = time.monotonic() - t0
        launches = read_counters()
        deltas = {c: global_metrics.counter(c) - before[c] for c in counters}
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        serve_ch.close()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        engine._dispatch_ragged_rows = ragged_rows
        engine._decode_fn = decode_fn
        engine._prefix.match = match
        engine._dispatch_spec = dispatch_spec
    for r, want in zip(one + two, [TURN1_TOKENS] * N_CONV + [TURN2_TOKENS] * N_CONV):
        if len(r["ids"]) != want or r["finish"] != "length":
            raise AssertionError(f"conversation stream ended early: {r}")
    for name in counters[:3]:
        if deltas[name] <= 0:
            raise AssertionError(f"{name} did not rise: {deltas}")
    sys_pages = len(system) // 16 * 16
    for i, (p1, p2) in enumerate(zip(firsts, seconds)):
        hist = hist_of.get(tuple(p2), 0)
        # Past the system prompt AND past turn 1's prompt pages: into the
        # answer's conversation-cache pages.
        if hist <= sys_pages or hist < len(p1) // 16 * 16 + 16:
            raise AssertionError(
                f"conversation {i}: turn-2 hit {hist} tokens does not reach "
                f"past the system prompt ({sys_pages}) into turn 1's answer "
                f"(turn 1 prompt {len(p1)} tokens)")
    check_engine_launches(engine, launches, steps[0], dispatches[0], spec[0])
    if engine._page_reserved or engine._prefix.reserved_pages:
        raise AssertionError("pool pages still reserved after every stream ended")
    ttfts = [r["ttft"] for r in one + two]
    return dict(one=one, two=two, wall=wall, launches=launches,
                dispatches=dispatches[0], steps=steps[0], spec=spec[0],
                deltas=deltas,
                hists=[hist_of.get(tuple(p), 0) for p in seconds],
                sys_pages=sys_pages,
                tok_s=sum(len(r["ids"]) for r in one + two) / wall,
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                ttft_max_ms=max(ttfts) * 1e3,
                turn1_ttft_p50_ms=statistics.median(r["ttft"] for r in one) * 1e3,
                turn2_ttft_p50_ms=statistics.median(r["ttft"] for r in two) * 1e3)


def decode_launches(engine, steps: int = 4) -> float:
    """``--profile``: CUDA kernels (and copies) the model launches per
    decode step — per verify burst of SPEC_T tokens on a speculating engine
    — on this engine's weights and cache, every slot live at position 200,
    view 256, no sampling, counted by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    rows = engine.ecfg.num_slots + 1
    toks = torch.ones((rows,), dtype=torch.long, device=engine.device)
    pos = torch.full((rows,), 200, dtype=torch.int32, device=engine.device)

    def step():
        if engine.ecfg.spec_ngram > 0:
            tr.spec_verify_into_cache(engine.mcfg, engine.params,
                                      toks[:, None].expand(rows, SPEC_T),
                                      pos, engine.kv_cache, kv_view=256)
        else:
            tr.decode_step(engine.mcfg, engine.params, engine.kv_cache, toks,
                           pos, kv_view=256)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA) / steps


def cli_engine(params, cfg, *flags):
    """The engine ``tunnel-gpu serve --backend gpu`` builds from ``flags``
    (16 slots, 1024 positions), on the given weights."""
    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer

    ecfg = cli._engine_config(cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", MODEL,
        "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ), *flags]))
    engine = InferenceEngine(engine_cfg=ecfg, params=params,
                             tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size))
    if engine.config_fences:
        raise AssertionError(f"engine {flags} fenced: {engine.config_fences}")
    return engine


def run_engine(engine, phase, profile: bool = False):
    """Start the engine, warm it up, run ``phase(engine)`` (and the
    ``--profile`` window), stop it; returns (seconds to ready, result)."""
    t0 = time.monotonic()

    async def drive():
        await engine.start()
        try:
            await engine.warmup()
            t_ready = time.monotonic() - t0
            out = await phase(engine)
            if profile:
                out["profile"] = await profile_phase(engine, NUM_SLOTS, MAX_TOKENS)
                out["launches_per_step"] = decode_launches(engine)
            return t_ready, out
        finally:
            await engine.stop()

    return asyncio.run(drive())


def free_engine(engine) -> None:
    """Drop an engine's device state (cache, pool) before the next is built."""
    import gc

    import torch

    engine.kv_cache = None
    engine._pool = None
    gc.collect()
    torch.cuda.empty_cache()


def print_mux(tag: str, engine, mux: dict, t_ready: float, name: str) -> None:
    ec = engine.ecfg
    print(f"{tag} {MODEL} bf16 serve-CLI defaults (mux {ec.mux}, prefix cache "
          f"{ec.prefix_cache}, conv cache {ec.conv_cache}, ragged "
          f"{ec.ragged_prefill}, kv_quant {ec.kv_quant}, fused decode layer "
          f"{ec.fused_decode_layer}, prefill_chunk {ec.prefill_chunk}, ragged "
          f"TOT {engine._ragged_tot}) ready in {t_ready:.1f} s; "
          f"{N_CONV} conversations x 2 turns ({TURN1_TOKENS} + {TURN2_TOKENS} "
          f"tokens), system prompt {len(SYSTEM_PROMPT)} tokens")
    for r in mux["one"] + mux["two"]:
        print(f"{tag}   {r['kind']:<6} tokens {len(r['ids'])} finish "
              f"{r['finish']} ttft {r['ttft'] * 1e3:.1f} ms total "
              f"{r['seconds']:.2f} s")
    print(f"{tag} counters {mux['deltas']}; turn-2 pool hits {mux['hists']} "
          f"tokens (system prompt pages {mux['sys_pages']} tokens)")
    nonzero = {k: v for k, v in mux["launches"].items() if v}
    print(f"{tag} ragged dispatches {mux['dispatches']}, decode steps "
          f"{mux['steps']}, verify bursts {mux['spec']}, launch counts {nonzero}")
    print(f"{tag} {mux['tok_s']:.1f} tok/s ({name}; both turns, client side "
          f"through the tunnel)")
    print(f"{tag} TTFT p50 {mux['ttft_p50_ms']:.1f} ms, max "
          f"{mux['ttft_max_ms']:.1f} ms (turn 1 p50 "
          f"{mux['turn1_ttft_p50_ms']:.1f} ms, turn 2 p50 "
          f"{mux['turn2_ttft_p50_ms']:.1f} ms; {name})")
    if "profile" in mux:
        print_profile(f"{tag} profile", mux["profile"], name)
        what = (f"verify burst of {SPEC_T} tokens" if engine.ecfg.spec_ngram > 0
                else "decode step")
        print(f"{tag} profile: {mux['launches_per_step']:.1f} CUDA launches per "
              f"{what} (model only, {engine.mcfg.n_layers} layers; fused "
              f"decode layer {engine.mcfg.fused_decode_layer})")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 5, 6a and 7, profile each engine "
                         "with every slot busy (device busy share, time by "
                         "kernel) and count the CUDA launches of one decode "
                         "step (phase 7: one verify burst)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks); "
                         "prints no result line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from p2p_llm_tunnel_tpu_torch.ops import kernel_build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    print(f"[card] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # Phase 1: build.
    t0 = time.monotonic()
    kernel_build.build()
    print(f"[build] {len(kernel_build.KERNEL_SOURCES)} kernels built in "
          f"{time.monotonic() - t0:.1f} s")
    for kname, info in kernel_build.BUILD_LOG.items():
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")

    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    cfg = get_config(MODEL)

    # Phase 2: kernels against their plain versions.
    reset_counters()
    rows = kernel_phase(cfg)
    other_errs = preset_checks()
    other_errs.update(ragged_preset_checks())
    print("[kernels] max |kernel 5 - T sequential kernel-4 launches| over every "
          f"geometry and burst width (tolerance {ATOL} + {RTOL}*|ref|; caches "
          "bit-exact; two launches on equal inputs bitwise equal): "
          + ", ".join(f"{k} {v:.3e}" for k, v in SEQ_DIFF.items()))
    phase2_launches = read_counters()
    if args.kernels_only:
        return 0

    # Phase 3: the serving path through the tunnel (and --profile).
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer

    t0 = time.monotonic()
    engine = InferenceEngine(
        engine_cfg=EngineConfig(model=MODEL, num_slots=NUM_SLOTS,
                                max_seq=MAX_SEQ, dtype="bfloat16"),
        tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size),
    )

    async def drive():
        await engine.start()
        try:
            await engine.warmup()
            t_ready = time.monotonic() - t0
            served = await serve_phase(engine, N_REQUESTS, MAX_TOKENS)
            if args.profile:
                served["profile"] = await profile_phase(
                    engine, NUM_SLOTS, MAX_TOKENS)
            return t_ready, served
        finally:
            await engine.stop()

    t_ready, serve = asyncio.run(drive())
    # Launches per kernel-table row, summed over the main-path phases.
    launches = dict.fromkeys(read_counters(), 0)

    def add_launches(counts: dict) -> None:
        for key, n in counts.items():
            launches[key] += n

    add_launches(serve["launches"])
    print(f"[serve] {MODEL} bf16 ready in {t_ready:.1f} s (init + warmup); "
          f"{N_REQUESTS} streams x {MAX_TOKENS} tokens, "
          f"{serve['waves']} prefill waves, {serve['steps']} decode steps")
    for r in serve["results"]:
        print(f"[serve]   {r['kind']:<6} tokens {r['tokens']} finish "
              f"{r['finish']} ttft {r['ttft'] * 1e3:.1f} ms "
              f"total {r['seconds']:.2f} s")
    print(f"[serve] {serve['tok_s']:.1f} tok/s, TTFT p50 "
          f"{serve['ttft_p50_ms']:.1f} ms, max {serve['ttft_max_ms']:.1f} ms "
          f"({name}; client side through the tunnel, launch counts "
          f"{ {k: v for k, v in serve['launches'].items() if v} })")
    if "profile" in serve:
        print_profile("[profile]", serve["profile"], name)

    # Phase 4: kernel path vs plain path on the same weights — the raw
    # cache with kernel 2, and the int4 cache with the fused decode layer.
    for quant, fused in ((None, False), ("int4", True)):
        lg = logits_phase(cfg, engine.params, quant=quant, fused=fused)
        print(f"[logits] kv_quant {quant}, fused decode layer {fused}: prefill "
              f"+ {lg['rows'] - 1} teacher-forced decode steps: max |kernel - "
              f"plain| {lg['max_abs_diff']:.4g} (limit {lg['limit']:.4g} = 5% "
              f"of max |logit| {lg['logit_scale']:.4g}), argmax agreement "
              f"{lg['argmax_agree']:.2f}")
    sl = spec_logits_phase(cfg, engine.params)
    print(f"[logits] int4 + fused verify burst of {sl['rows']} tokens (kernel 5) "
          f"vs {sl['rows']} sequential decode steps (kernel 4): max |diff| "
          f"{sl['max_abs_diff']:.4g} (limit {sl['limit']:.4g}), argmax agreement "
          f"{sl['argmax_agree']:.2f}; cache entries that differ "
          f"{sl['cache_mismatch']} of {sl['cache_entries']}")

    # Phase 5: the serve CLI's default engine + --ragged-prefill on the same
    # weights; each engine's cache is freed before the next is built.
    params = engine.params
    free_engine(engine)
    del engine
    mux_engine = cli_engine(params, cfg, "--ragged-prefill")
    t_ready, mux = run_engine(mux_engine, mux_phase, args.profile)
    print_mux("[mux]", mux_engine, mux, t_ready, name)
    add_launches(mux["launches"])
    free_engine(mux_engine)
    del mux_engine

    # Phase 6: the quantized caches on the same defaults and conversations.
    # 6a: int4 + fused decode layer + ragged prefill (kernels 4 and 6 in
    # their int4 forms, kernel 2 idle, packed int4 pool pages).
    e6a = cli_engine(params, cfg, "--kv-quant", "int4", "--fused-decode-layer",
                     "--ragged-prefill")
    from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import pool_packed_keys

    if (pool_packed_keys(e6a.kv_cache) != frozenset({"k", "v"})
            or e6a._pool["k"].shape[2] * 2 != e6a._prefix_block
            or e6a._pool["k_scale"].shape[2] != e6a._prefix_block):
        raise AssertionError("int4 engine's pool pages are not packed half pages")
    t_ready, m6a = run_engine(e6a, mux_phase, args.profile)
    print_mux("[6a]", e6a, m6a, t_ready, name)
    if any(m6a["launches"][row_name("flash_decode_attention", f)] for f in FORMS):
        raise AssertionError("kernel 2 launched on the fused engine")
    add_launches(m6a["launches"])
    free_engine(e6a)
    del e6a
    # 6b: int8 on the defaults (unfused: kernel 2's int8 form).
    e6b = cli_engine(params, cfg, "--kv-quant", "int8")
    t_ready, m6b = run_engine(e6b, mux_phase)
    print_mux("[6b]", e6b, m6b, t_ready, name)
    add_launches(m6b["launches"])
    free_engine(e6b)
    del e6b
    # 6c: the remaining (kernel, KV form) pairs, a few short streams each.
    for flags in (("--kv-quant", "int8", "--fused-decode-layer", "--ragged-prefill"),
                  ("--fused-decode-layer",),
                  ("--kv-quant", "int4", "--no-mux")):
        e6c = cli_engine(params, cfg, *flags)
        t_ready, short = run_engine(e6c, lambda e: serve_phase(e, 4, 16))
        nonzero = {k: v for k, v in short["launches"].items() if v}
        print(f"[6c] {' '.join(flags)}: ready in {t_ready:.1f} s; 4 streams x "
              f"16 tokens finished; {short['waves']} prefill waves, "
              f"{short['steps']} decode steps, {short['dispatches']} ragged "
              f"dispatches, launch counts {nonzero}")
        add_launches(short["launches"])
        free_engine(e6c)
        del e6c

    # Phase 7: prompt-lookup speculation on the serve CLI's defaults with
    # the int4 cache, fused layers and ragged prefill — the same
    # conversations as 6a, every verify burst through kernel 5 (int4).
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    e7 = cli_engine(params, cfg, "--kv-quant", "int4", "--fused-decode-layer",
                    "--ragged-prefill", "--spec-ngram", "3", "--spec-k", "4",
                    "--spec-k-max", "8")
    t_ready, m7 = run_engine(e7, mux_phase, args.profile)
    print_mux("[7]", e7, m7, t_ready, name)
    proposed = m7["deltas"]["engine_spec_proposed_tokens_total"]
    accepted = m7["deltas"]["engine_spec_accepted_tokens_total"]
    if m7["spec"] <= 0 or proposed <= 0:
        raise AssertionError(f"phase 7 ran {m7['spec']} verify bursts, "
                             f"{proposed} proposals")
    if any(m7["launches"][row_name("flash_decode_attention", f)] for f in FORMS):
        raise AssertionError("kernel 2 launched on the fused spec engine")
    if global_metrics.gauge("engine_spec_hist_entries") != 0:
        raise AssertionError("spec proposer state outlived its requests")
    print(f"[7] verify bursts {m7['spec']} (kernel 5 int4 "
          f"{m7['launches']['fused_spec_decode_layer_int4']} = "
          f"{e7.mcfg.n_layers} x {m7['spec']}), plain decode steps {m7['steps']} "
          f"(kernel 4 int4 {m7['launches']['fused_decode_layer_int4']}); "
          f"proposed {proposed:.0f}, accepted {accepted:.0f}, acceptance rate "
          f"{accepted / proposed:.3f}; {m7['tok_s']:.1f} tok/s, TTFT p50 "
          f"{m7['ttft_p50_ms']:.1f} ms ({name}); spec hist entries 0")
    agree = []
    for a, b in zip(m7["one"] + m7["two"], m6a["one"] + m6a["two"]):
        n = next((i for i, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y),
                 min(len(a["ids"]), len(b["ids"])))
        agree.append(n)
    print(f"[7] tokens before the first divergence from 6a, per stream (turn 1, "
          f"then turn 2; printed, not required — on the card greedy identity "
          f"with speculation on and off is not claimed: cuBLAS products differ "
          f"at M = B*T and M = B, and kernel 5 sums in another order than "
          f"kernel 4): {agree}")
    add_launches(m7["launches"])
    free_engine(e7)
    del e7
    # 7b: the other kernel-5 forms, and the unfused verify (the chunk path
    # with the int4 splice), a few short streams each.
    for flags in (("--fused-decode-layer", "--spec-ngram", "3"),
                  ("--kv-quant", "int8", "--fused-decode-layer", "--spec-ngram", "3"),
                  ("--kv-quant", "int4", "--spec-ngram", "3")):
        e7b = cli_engine(params, cfg, *flags)
        t_ready, short = run_engine(e7b, lambda e: serve_phase(e, 4, 16))
        if short["spec"] <= 0:
            raise AssertionError(f"{flags}: no verify burst ran")
        nonzero = {k: v for k, v in short["launches"].items() if v}
        print(f"[7b] {' '.join(flags)}: ready in {t_ready:.1f} s; 4 streams x "
              f"16 tokens finished; {short['waves']} prefill waves, "
              f"{short['steps']} decode steps, {short['spec']} verify bursts, "
              f"launch counts {nonzero}")
        add_launches(short["launches"])
        free_engine(e7b)
        del e7b
    del params

    source = {
        "flash_causal_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/flash_causal_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_attention.py:136"),
        "flash_decode_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/flash_decode_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py:446"),
        "flash_decode_attention_plane": (
            "p2p_llm_tunnel_tpu_torch/csrc/flash_decode_attention_plane.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py:219"),
        "fused_decode_layer": (
            "p2p_llm_tunnel_tpu_torch/csrc/fused_decode_layer.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py:877"),
        "fused_spec_decode_layer": (
            "p2p_llm_tunnel_tpu_torch/csrc/fused_spec_decode_layer.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py:1365"),
        "ragged_prefill_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/ragged_prefill_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py:563"),
    }
    table = []
    for rname, cases in rows.items():
        kname = max((k for k in source if rname == k or rname.startswith(k + "_")),
                    key=len)
        tag = JSON_SHAPES.get(kname)
        pick = next((r for r in cases if tag and f" {tag} " in f" {r['shape']} "),
                    cases[0])
        extra = {}
        if rname in CROSS_CHECK_ONLY:
            # No serving path calls it (checked above): its row counts
            # phase 2's launches.
            n = phase2_launches[rname]
            extra["note"] = CROSS_CHECK_ONLY[rname]
        else:
            n = launches[rname]
            if n <= 0:
                raise AssertionError(f"{rname} was launched no time on the main path")
        table.append(dict(
            name=rname, route="cuda", source=source[kname][0],
            replaces=source[kname][1], launches=n,
            max_abs_err=max([r["max_abs_err"] for r in cases]
                            + [other_errs.get(rname, 0.0)]),
            ms=pick["ms"], ms_spread=pick["ms_spread"], plain_ms=pick["plain_ms"],
            bound_ms=pick["bound_ms"], bound_by=pick["bound_by"],
            library_ms=pick["library_ms"],
            library_device_ms=pick["library_device_ms"], shape=pick["shape"],
            **{k: pick[k] for k in ("device_ms",) if k in pick}, **extra,
        ))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
