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
   path's int4 splice);
8. weight quantization, every projection and the head through kernel 7
   (225 launches per prefill call, decode step and verify burst on
   llama3-8b, in the prefill or decode config's form), on weights drawn
   directly quantized from seed 0: (a) 6a's engine with ``--quant int4
   --quant-group-size 128`` on the conversations of phase 5; (b) the
   serve defaults + ``--ragged-prefill`` with ``--quant int8
   --prefill-act-quant`` (prefill W8A8, decode weight-only); (c) ``--quant
   w8a8`` (4 streams x 16 tokens) and 8a with speculation; (d) llama3-70b
   at full width and depth with ``--quant int4 --kv-quant int8`` (4
   streams), its weight bytes and peak memory printed; (e) tiny-qwen with
   ``--quant int4`` (its untied head of 259 columns in kernel 7's padded
   rows), 4 streams;
9. the slice of embeddings, mixture-of-experts and checkpoints: (a) on
   phase 5's llama3-8b engine (full width, 32 layers), /v1/embeddings of
   ``prefill_rows + 1`` inputs of different lengths, each input alone and
   /api/embed through the tunnel — 4096 dimensions, unit norms, each
   vector against the input alone and against ``encode_pooled`` with
   kernel 1's plain version (real rows), kernel 1 once per layer per
   sub-batch, ms per call; (b) mixtral-8x7b's widths at 8 of 32 layers
   (random bf16 weights from seed 0): kernel-vs-plain logits as phase 4,
   the 8 two-turn conversations on the plain loop and on the serve
   defaults + ``--ragged-prefill``, short streams with ``--kv-quant int4
   --fused-decode-layer`` and with ``--spec-ngram 3 --spec-k 4``, launches
   per layer per step checked, tok/s, TTFT p50 and peak memory; (c)
   llama3-8b's widths at 2 layers: an HF state dict from seed 0 through
   ``convert_hf("llama")`` and ``save_checkpoint`` under build/, an engine
   from the serve flags with ``--ckpt`` whose greedy streams through the
   tunnel are byte-identical to an engine injected with the converted
   weights; file bytes and load seconds.  Each prints its seconds and peak
   memory beside the card's name and power limit.
10. the prefix pool's host-RAM spill tier, pool snapshots and KV_PAGES
   disaggregation on phase 5's llama3-8b weights (run after phase 7,
   while those weights live): (a) phase 5's conversations on the serve
   defaults + ``--ragged-prefill --spill-pages 256`` with an 84-block pool,
   below their working set (printed): pages go out, the second turns of at
   least 4 conversations take their history through page-ins, every
   spliced page re-exports with its page-out checksum, every stream
   finishes, no copy stays in flight, and the launch checks of phase 5
   hold; then one new conversation of the system prompt, and the engine
   stops and saves its pool under ``build/chip_smoke_snapshot`` (removed
   after); the same with ``--kv-quant int4 --fused-decode-layer`` (packed
   pages); per-page ms, host-tier bytes and agreement with the tier-off
   engine printed; (b) a fresh engine from the same flags restores the
   pool (its checksum the saved one), its index matches the system
   prompt's 19 pages before any prefill, and an engine at ``--kv-quant
   int8`` on the directory starts cold; file bytes, save and load
   seconds; (c) a ``--role prefill`` and a ``--role decode`` engine on one
   weight tree behind ``run_proxy_fabric``: the conversations through the
   fabric, every page shipped offered to the decode peer and either
   spliced or already resident there, no fallback and no refusal, every
   spliced page re-exported with the sender's checksum, no transfer in
   flight after; transfer bytes, ms a page and TTFT against phase 5.
11. ``--tp 2`` as two ranks on the one card (rank 1 a spawned process,
   gloo): (b) tp 2 against tp 1 logits on the same weights; (a) the serve
   defaults' conversations and the plain loop; (c) ``--quant int4
   --kv-quant int8``, each rank checking its own launches; (d)
   ``--replicas 2`` behind one router.
12. sequence parallelism at llama3-8b's full width, ranks on the one card
   (spawned processes, gloo: every exchange in its zero-padded all-reduce
   form, printed): (a) sp 2 prefill logits of a 4096-token prompt, ring
   and Ulysses, against one rank's forward on the same weights (11b's
   bound, argmax agreement, K/V printed); (b) ``--sp 2 --sp-mode ring``
   on the serve defaults (fenced to mux with whole-prompt waves), bf16
   KV, prompts of 1500-3800 tokens in 4096-position slots; (c) ``--sp 2
   --sp-mode ulysses --kv-quant int4 --fused-decode-layer``; (d) tp 2 x
   sp 2 logits over four ranks, depth cut to 8 layers.  Each rank checks
   its own launches (kernel 1 32 a Ulysses wave and none on ring, the
   decode kernel 32 a step); tok/s, TTFT p50, each rank's peak memory and
   the exchanges run are printed.
13. expert and data parallelism, ranks on the one card (spawned
   processes, gloo): (a) mixtral-8x7b's widths at 8 layers, each rank
   drawing only its shard of the seed-0 tree: ep 2 prefill logits of a
   1024-token prompt against one rank's whole tree (11b's bound), each
   rank holding half the expert bytes; (b) ``--ep 2`` on the serve
   defaults + ``--ragged-prefill``, phase 5's conversations; (c) tp 2 x
   ep 2 logits over four ranks; (d) llama3-8b at full width and depth,
   ``--dp-dcn 2`` through the serve CLI's ``--coordinator`` flags over 15
   slots (8 of the 16 cache rows a rank), 12 conversations on the serve
   defaults + ragged, on ``--kv-quant int4 --fused-decode-layer
   --spec-ngram 3`` and on ``--quant int4``: each rank holds half the
   cache bytes, its rows of a whole-prompt wave into every slot against
   one rank's ``prefill_into_cache`` of that wave (int4 codes and scales
   bitwise, bf16 within 5% of each layer's max), and its own launches.
   ``--ep-nccl`` (four cards, not in the default run): 13e, mixtral-8x7b
   at full depth over ep 4 on NCCL — the 8-layer logits against one
   rank's, the ep all-reduce's ms a call at a decode step's and a
   1024-token wave's shapes, and phase 5's conversations: tok/s, TTFT
   p50 and each card's peak memory.
14. training (the first backward path): (a) kernel 1 under its autograd
   Function (the kernel forward on bf16 copies, the plain version's
   gradient backward) at B 8, T 256 with ragged lengths, at llama3-8b's
   and llama3.2-1b's heads: forward bitwise a direct launch, dq/dk/dv
   against the plain version's gradient on the same bf16 inputs, forward
   and backward ms; (b) llama3.2-1b at full width and depth, fp32 weights
   from seed 0, ``make_train_step`` at dp 1 x tp 1, lr 1e-3, five steps on
   one fixed B 8 x T 256 batch: losses finite and descending, step 1's loss
   and gradients against the same step with the plain attention (the same
   bf16 casts), kernel 1 16 times a step, ms a step, tokens/s and peak
   memory; (c) dp 2 x tp 2 over four gloo ranks on the card at 4 layers,
   each rank's loss and gradients against one rank's whole-tree step,
   moments at the shard shapes, three steps descending; (d) pp 2 over two
   gloo ranks at full depth (8 layers a stage), ``n_micro`` 4: each
   stage's loss and gradients against one rank's unsharded ``loss_fn``,
   ms a value-and-grad.
15. the ``testing/`` twin: (a) ``python -m
   p2p_llm_tunnel_tpu_torch.testing.local_stack --model llama3-8b --slots
   16 --max-seq 1024`` as a child process on the card (all 32 layers at
   llama3-8b's widths, the byte tokenizer's 259-id vocabulary as
   ``tunnel-gpu serve`` without ``--tokenizer``; the kernels of phase 1,
   no second build), driven by ``scripts/loadgen.py --port P --tenant
   herd:32:2 --max-tokens 64``: loadgen exits 0 (no stuck stream, no
   leaked slot) with every stream ok, ``/healthz``'s
   ``decode_kernels_per_step`` equals the decode launch report of an
   engine of the twin's configuration built here first, its
   ``warmup_compile_s`` is positive, and SIGTERM ends the twin with exit
   0; loadgen's TTFT p50/p99 and content tokens a second are printed; (b)
   the same twin with ``--disagg`` (a prefill and a decode engine on the
   card) under loadgen ``--turns 2 --tenant conv:8``: every stream ok and
   KV pages shipped (``/metrics``); (c) the decode launch reports
   (``InferenceEngine.decode_launch_report``) of phases 3 and 6's engines
   — one hand-written kernel per layer-step on the kernel-2 and the fused
   paths, each engine's ``engine_decode_kernels_per_step`` gauge equal to
   its report, the fused layer body at least 40% (int8, int4) or 30%
   (raw) fewer ops than the unfused one, the reference's thresholds —
   checked after phase 6, and tiny's report on the card equal to the
   CPU's at phase 3's and 6a's configurations.

Phase 2 holds every kernel in every KV form (raw, int8, int4): attention
within tolerance, quantized cache bytes and scales bit-exact; kernel 5
also within the same tolerance of T sequential kernel-4 launches (the
max difference printed; caches bit-exact); kernels 2, 4 and 5 also
bitwise equal over two launches on equal inputs; kernel 3 (raw only; no
serving path calls it) also against kernel 2; kernel 6 also at q-block
widths 8 and 32; kernel 7 (int8, w8a8, int4) at every llama3-8b
projection and the head at 17, 85 and 1024 rows, a tied head and group
64, tiny-qwen's head (N 259) at 1, 17 and 153 rows, a K tail (K 4100) and
int4 groups 8 and 24, w8a8 bitwise equal to its plain version (exact
int32 sums); phase 4
also holds model logits through kernel 7 against its plain version.  Kernel rows report the median of three timing runs and
their spread; every kernel row and its library call is timed L2-cold (the
inputs rotate over copies, or the layer over a stacked cache, larger than
twice the L2) and carries the kernel's device time alone
(torch.profiler).  The line before the last is
the kernel table as one JSON object, one row per (kernel, KV form); the
last line is ``{"ok": true, "device": {...}}``.
``--profile`` adds a torch.profiler window over the plain-loop engine and
the mux engines of phases 5, 6a, 7 and 8a with every slot busy (device
busy share, device time by kernel), and the CUDA launches of one decode
step on the mux engines of phases 5, 6a and 8a (8a: with kernel 7's
device ms per step beside the weight-stream bound) and of one verify
burst on phase 7's.
``--kernels-only`` stops after phase 2; ``--tp-only``, ``--sp-only``,
``--ep-only``, ``--train-only`` and ``--twins-only`` build and run phase
11, 12, 13, 14 or 15 (without 15c's llama3-8b reports) alone.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional

# Published peaks of one H100 SXM (dense): bf16 and int8 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

MODEL = "llama3-8b"
#: Where phase 9's weights and engines live: the card (a CPU rehearsal of
#: the phase's control flow sets "cpu").
DEVICE = "cuda"
NUM_SLOTS = 16
MAX_SEQ = 1024
N_REQUESTS = 8  # concurrent streams through the tunnel, SSE and NDJSON
MAX_TOKENS = 64  # tokens each stream asks for
#: The kernel-table row the JSON line reports: the prefill bucket and the
#: decode view the main path's prompts (120-400 bytes) land in.
JSON_SHAPES = {"flash_causal_attention": "T256", "flash_decode_attention": "S512",
               "flash_decode_attention_plane": "S512",
               "fused_decode_layer": "view512", "fused_spec_decode_layer": "T5 view512",
               "ragged_prefill_attention": "TOT1024",
               "quant_matmul": "w_gate/w_up N14336 K4096 M17"}
#: Kernel 3 has no serving path (in the JAX package either): its row counts
#: phase 2's launches and is exempt from the main-path launch check.
CROSS_CHECK_ONLY = {"flash_decode_attention_plane":
                    "cross-check only: no serving path in the JAX package either"}
#: The ``__global__`` names of the port's kernels, as the profiler reports
#: them (``--profile`` lists each beside the window's top 14).
PORT_KERNEL_NAMES = ("flash_causal_kernel", "flash_decode_kernel",
                     "plane_decode_kernel", "fused_decode_layer_kernel",
                     "fused_spec_kernel", "ragged_prefill_kernel",
                     "quant_matmul_decode_kernel", "quant_matmul_prefill_kernel",
                     "quantize_rows_kernel")
#: Kernel 7's CUDA kernels: its two plans and W8A8's activation quantizer,
#: all launched by the one wrapper call a product makes.
K7_KERNELS = ("quant_matmul_decode_kernel", "quant_matmul_prefill_kernel",
              "quantize_rows_kernel")
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


# Profiler windows device_ms takes before it gives a time up as not measured.
WINDOWS = 5


def device_ms(fn, kernel, iters: int = 50) -> Optional[float]:
    """Device time per launch of the CUDA kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn`` under torch.profiler: the
    kernel alone, without the host time between launches that CUDA events
    also see when a call enqueues slower than the card runs it.  With a
    tuple of names: the sum of each name's time per launch over the names
    the window shows (the kernels one call launches once each, as kernel
    7's plan and W8A8 quantizer).  With ``kernel`` None: the device time of
    every kernel ``fn`` launches, per call (a library call's).

    A profiler window can come back with some or all of the device's
    events missing (seen on the card, now and then several windows in a
    row): a kernel's time is averaged over the launches the window shows,
    and a window that shows none is taken again, up to ``WINDOWS`` times;
    a library call's total is the fullest of three windows (a window never
    shows more than ran), or of up to ``WINDOWS`` while all are empty.  When every window came back empty the
    time is not measured: None, with a note on stderr.  It is a reading
    beside the kernel's CUDA-event ``ms``, never a check, so a blind
    profiler does not fail the run."""
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
        totals = []
        while len(totals) < WINDOWS and (len(totals) < 3 or max(totals) <= 0):
            totals.append(sum(dev_us(e) for e in window()))
        if max(totals) > 0:
            return max(totals) / iters / 1e3
    else:
        names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
        for _ in range(WINDOWS):
            evs = window()
            total, seen = 0.0, 0
            for name in names:
                events = [e for e in evs if name in e.key]
                count = sum(e.count for e in events)
                if count:
                    total += sum(dev_us(e) for e in events) / count / 1e3
                    seen += 1
            if seen:
                return total
    print(f"[profiler] {WINDOWS} windows showed no device time of "
          f"{kernel or 'the library call'}: its device ms is not measured",
          file=sys.stderr)
    return None


def fmt_ms(ms) -> str:
    """A device ms for a printed line: "not measured" where it is None."""
    return "not measured" if ms is None else f"{ms:.4f}"


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


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak * 1e3
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


#: Kernel 7 at the main path's shapes (llama3-8b, N x K) and rows: one
#: stream, a decode step (16 slots + the parked row), a verify burst of T 5
#: and the widest of T 9, and a ragged dispatch of 1024 flat tokens.
QUANT_SHAPES = (("wq/wo", 4096, 4096), ("wk/wv", 1024, 4096),
                ("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336),
                ("lm_head", 128256, 4096))
QUANT_ROWS = (1, 17, 85, 153, 1024)
QUANT_FORMS = ("int8", "w8a8", "int4")
#: A tied head: llama3.2-1b's embedding [128256, 2048] (contracts its last
#: axis, the int4 table packed along it).
TIED_HEAD = ("tied head llama3.2-1b", 128256, 2048)
#: Shapes the reference serves that need kernel 7's padded rows, narrow
#: groups or K tail: tiny-qwen's untied head (rows of 259 bytes, stored
#: padded) at one stream, a decode step and the widest verify burst; a
#: contracted length no multiple of 16; int4 groups narrower than a k-step.
ODD_HEAD = ("tiny-qwen head", 259, 64, (1, 17, 153), 32)
K_TAIL = ("K tail", 1024, 4100)
NARROW_GROUPS = (8, 24)


def quant_weights(form, n, k, layers, layout, gs, g):
    """``layers`` random quantized weights of one shape, stacked: int8
    values or packed int4 bytes, and scales that vary per column (and
    group), so a kernel reading the wrong scale disagrees."""
    import torch

    kn = layout == "kn"
    if form == "int4":
        kp2 = -(-k // gs) * gs // 2
        q = torch.randint(-128, 128, (layers,) + ((kp2, n) if kn else (n, kp2)),
                          generator=g, device="cuda", dtype=torch.int8)
        groups = 2 * kp2 // gs
        scale = (torch.rand((layers,) + ((groups, n) if kn else (n, groups)),
                            generator=g, device="cuda") + 0.5) * (k**-0.5 / 7)
    else:
        q = torch.randint(-127, 128, (layers,) + ((k, n) if kn else (n, k)),
                          generator=g, device="cuda", dtype=torch.int8)
        scale = (torch.rand((layers, n), generator=g, device="cuda") + 0.5) * (
            k**-0.5 / 127)
    return q, scale


def quant_library(form, x, q, scale, layout, kw, layers):
    """Kernel 7's yardstick, L2-cold (a call the port never makes): int8
    and int4, ``torch.matmul`` of x with a bf16 copy of the dequantized
    weight (the call a bf16 engine makes), rotating over copies; w8a8,
    ``torch._int_mm`` of the quantized activations with the int8 weight
    where its shape rules admit it (else the reason)."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import quant as tq
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    if form == "w8a8":
        xq, _ = tq._quantize_act(x)
        mats = [q[i] if layout == "kn" else q[i].t() for i in range(layers)]
        try:
            torch._int_mm(xq, mats[0])
            torch.cuda.synchronize()
        except RuntimeError as e:
            return dict(library_ms=None, library_device_ms=None,
                        library_note=f"torch._int_mm refused: {str(e).splitlines()[0][:120]}")
        return library_times(rotating(lambda i: torch._int_mm(xq, mats[i]), layers))
    n, k = (q.shape[2], x.shape[1]) if layout == "kn" else (q.shape[1], x.shape[1])
    copies = library_copies(2 * n * k, layers)
    if form == "int4":
        dense = [tq._dequant4(tq.QTensor4(q[i], scale[i], kw["in_dim"], kw["group_size"],
                                          -2 if layout == "kn" else -1), torch.bfloat16)
                 for i in range(copies)]
    else:
        dense = [(q[i].to(torch.bfloat16) * (scale[i] if layout == "kn" else scale[i][:, None])
                  .to(torch.bfloat16)) for i in range(copies)]
    mats = [d if layout == "kn" else d.t() for d in dense]
    return library_times(rotating(lambda i: torch.matmul(x, mats[i]), copies))


def quant_case(form, name, n, k, m, layout="kn", gs=128, seed=0):
    """Kernel 7 in ``form`` against its plain version (bf16 within the
    kernel tolerance; w8a8 BITWISE — its int32 sums are exact — and every
    form bitwise over two launches), timed L2-cold over a stack of weight
    copies larger than ``L2_COLD_BYTES``, with its device time, bound,
    plain time and library yardstick."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import quant as tq
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(seed)
    wbytes = n * k // (2 if form == "int4" else 1)
    layers = max(2, -(-int(L2_COLD_BYTES) // wbytes) + 1)
    q, scale = quant_weights(form, n, k, layers, layout, gs, g)
    # Rows padded to whole 16-byte pieces where they are not, as the
    # engine lays its tree out (views at the logical shape).
    lay = tq.kernel_layout(tq.QTensor4(q, scale, k, gs, -2 if layout == "kn" else -1)
                           if form == "int4" else tq.QTensor(q, scale))
    q, scale = lay.q, lay.scale
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    kw = dict(in_dim=k, group_size=gs) if form == "int4" else {}
    args = dict(form=form, layout=layout, **kw)
    got = qm.quant_matmul(x, q[0], scale[0], **args)
    again = qm.quant_matmul(x, q[0], scale[0], **args)
    want = qm.plain(x, q[0], scale[0], **args)
    torch.cuda.synchronize()
    label = (f"{name} N{n} K{k} M{m}" + (f" g{gs}" if form == "int4" else "")
             + ("" if layout == "kn" else " nk"))
    if not torch.equal(got, again):
        raise AssertionError(f"quant_matmul_{form} {label}: two launches differ")
    plan = qm.launch_plan(m, n, k, form, layout, gs)
    if plan["splits"] > 1:
        SPLIT_BITWISE.append(f"{form} {name} M{m} ({plan['splits']} splits)")
    if form == "w8a8" and not torch.equal(got, want):
        raise AssertionError(
            f"quant_matmul_w8a8 {label}: not bitwise equal to its plain version "
            f"({int(got.ne(want).sum())} values differ)")
    err = check_close(f"quant_matmul_{form} {label}", got, want)
    scale_bytes = scale[0].numel() * 4
    nbytes = wbytes + scale_bytes + 2 * m * k + 2 * m * n
    launch = rotating(lambda i: qm.quant_matmul(x, q[i], scale[i], **args), layers)
    plain_iters = 2 if m * n * k > 1e11 else 5
    row = dict(
        shape=f"{label} L2-cold{layers}", max_abs_err=err,
        **kernel_ms(launch, iters=20),
        device_ms=device_ms(launch, K7_KERNELS, iters=20),
        plan=f"{plan['plan']} grid {plan['grid']}",
        plain_ms=timed_ms(lambda: qm.plain(x, q[0], scale[0], **args),
                          iters=plain_iters, warm=1)[0],
        **quant_library(form, x, q, scale, layout, kw, layers),
    )
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, 2 * m * n * k, PEAK_INT8_OPS if form == "w8a8" else PEAK_BF16_FLOPS)
    return row


#: Kernel 7's cases whose K was split, each bitwise equal over two launches.
SPLIT_BITWISE: list = []


def quant_phase() -> dict:
    """Kernel 7's rows: every form at every main-path shape and row count,
    the tied head, int4 at group size 64, tiny-qwen's head (N 259), a K
    tail and int4 at groups 8 and 24; every form bitwise over two launches
    at a split shape (wk/wv, M 17: 16 splits)."""
    rows = {f"quant_matmul_{form}": [] for form in QUANT_FORMS}
    for form in QUANT_FORMS:
        for name, n, k in QUANT_SHAPES:
            for m in QUANT_ROWS:
                rows[f"quant_matmul_{form}"].append(quant_case(form, name, n, k, m))
        name, n, k = TIED_HEAD
        rows[f"quant_matmul_{form}"].append(quant_case(form, name, n, k, 17, layout="nk"))
        name, n, k, ms, gs = ODD_HEAD
        for m in ms:
            rows[f"quant_matmul_{form}"].append(quant_case(form, name, n, k, m, gs=gs,
                                                           seed=2))
        name, n, k = K_TAIL
        rows[f"quant_matmul_{form}"].append(quant_case(form, name, n, k, 17, seed=3))
    rows["quant_matmul_int4"].append(quant_case("int4", "w_gate/w_up", 14336, 4096, 17,
                                                gs=64, seed=1))
    for gs in NARROW_GROUPS:
        rows["quant_matmul_int4"].append(quant_case("int4", "wk/wv", 1024, 4096, 17,
                                                    gs=gs, seed=4))
    # The tp 2 shard shapes phase 11 runs: a decode step (M 17) in every
    # form, and a prefill dispatch (M 1024) in int4.
    for form in QUANT_FORMS:
        for name, n, k in TP2_QUANT_SHAPES:
            rows[f"quant_matmul_{form}"].append(quant_case(form, name, n, k, 17, seed=5))
    for name, n, k in TP2_QUANT_SHAPES:
        rows["quant_matmul_int4"].append(quant_case("int4", name, n, k, 1024, seed=6))
    for form in QUANT_FORMS:
        if not any(c.startswith(f"{form} wk/wv M17 ") for c in SPLIT_BITWISE):
            raise AssertionError(f"kernel 7 {form}: wk/wv at M 17 was not split")
    print("[kernels] kernel 7 bitwise over two launches where K is split: "
          + ", ".join(SPLIT_BITWISE))
    return rows


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
    # Kernels 1 and 2 at one tp 2 rank's head shard (H/2 query, K/2 kv
    # heads), as phase 11 launches them; after the JSON rows' cases.
    hs, khs = h // TP, kh // TP
    rows["flash_causal_attention"].append(prefill_case(8, 256, hs, khs, d, [256] * 8,
                                                       seed=3))
    for form in FORMS:
        rows[row_name("flash_decode_attention", form)].append(
            decode_case(b, 512, hs, khs, d, decode_positions(b, 512), form=form, seed=3))
    # Kernel 1 at Ulysses' shapes: an sp 2 rank's H/2 query and K/2 kv
    # heads over the whole sequence, in phase 12c's waves (2 rows).
    for t in (2048, 4096):
        rows["flash_causal_attention"].append(prefill_case(
            SP_PREFILL_ROWS, t, h // SP, kh // SP, d, [t] * SP_PREFILL_ROWS, seed=4))
    rows.update(quant_phase())
    for name, cases in rows.items():
        print(f"[kernels] {name} (bf16 activations, fp32 math; tolerance "
              f"{ATOL} + {RTOL}*|ref|; quantized caches bit-exact"
              + ("; w8a8 bitwise" if name.startswith("quant_matmul") else "") + ")")
        for r in cases:
            lib = (r.get("library_note", "n/a") if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} (device {fmt_ms(r['library_device_ms'])})")
            dev = f" (device {fmt_ms(r['device_ms'])} ms)" if "device_ms" in r else ""
            if "plan" in r:
                dev += f" [{r['plan']}]"
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
    from p2p_llm_tunnel_tpu_torch.ops.quant_matmul import quant_matmul

    return {"flash_causal_attention": flash_causal_attention,
            "flash_decode_attention": flash_decode_attention,
            "flash_decode_attention_plane": flash_decode_attention_plane,
            "fused_decode_layer": fused_decode_layer,
            "fused_spec_decode_layer": fused_spec_decode_layer,
            "ragged_prefill_attention": ragged_prefill_attention,
            "quant_matmul": quant_matmul}


#: The engine's model-level calls since the last reset, by kind: kernel 7
#: launches once per quantized product, 7 per layer + the head per call.
MODEL_CALLS = {"prefill": 0, "decode": 0}
_PREFILL_FNS = ("prefill_into_cache", "chunk_prefill_into_cache",
                "ragged_prefill_into_cache")
_DECODE_FNS = ("decode_step", "spec_verify_into_cache")


def count_model_calls() -> None:
    """Wrap the model functions the engine calls (its module's names) so
    each call counts as a prefill or a decode-side call (a decode step or
    a verify burst; an unfused verify's inner chunk call is not the
    engine's and is not counted)."""
    from p2p_llm_tunnel_tpu_torch.engine import engine as eng_mod

    def counted(fn, kind):
        def call(*a, **kw):
            MODEL_CALLS[kind] += 1
            return fn(*a, **kw)
        call.counted = True
        return call

    for kind, names in (("prefill", _PREFILL_FNS), ("decode", _DECODE_FNS)):
        for name in names:
            fn = getattr(eng_mod, name)
            if not getattr(fn, "counted", False):
                setattr(eng_mod, name, counted(fn, kind))


def reset_counters() -> None:
    """Zero every wrapper's launch counters (total and per form), the
    model-call counts and the sp exchange counts."""
    from p2p_llm_tunnel_tpu_torch.parallel import collectives

    collectives.exchanges.clear()
    for fn in _kernels().values():
        fn.launches = 0
        for key in getattr(fn, "form_launches", {}):
            fn.form_launches[key] = 0
    for key in MODEL_CALLS:
        MODEL_CALLS[key] = 0


def uncounted(fn):
    """``fn`` with every counter of ``reset_counters`` as it found them
    after the call: a follower replays rank 0's launch-report probe (its
    warmup dispatches one), whose launches are the report's, not the
    serving path's."""
    from p2p_llm_tunnel_tpu_torch.parallel import collectives

    def call(*a):
        kernels = {k: (f.launches, dict(getattr(f, "form_launches", {})))
                   for k, f in _kernels().items()}
        calls, exchanges = dict(MODEL_CALLS), dict(collectives.exchanges)
        try:
            return fn(*a)
        finally:
            for k, f in _kernels().items():
                f.launches = kernels[k][0]
                for key, n in kernels[k][1].items():
                    f.form_launches[key] = n
            MODEL_CALLS.update(calls)
            collectives.exchanges.clear()
            collectives.exchanges.update(exchanges)

    return call


def read_counters() -> dict:
    """Launches since the last reset, per kernel-table row."""
    out = {}
    for kname, fn in _kernels().items():
        if not hasattr(fn, "form_launches"):
            out[kname] = fn.launches
            continue
        for key, n in fn.form_launches.items():
            out[row_name(kname, None if key == "none" else key)] = n
    return out


def engine_form(engine):
    return None if engine.ecfg.kv_quant in ("none", "") else engine.ecfg.kv_quant


def check_engine_launches(engine, launches: dict, steps: int,
                          dispatches: int, spec: int = 0,
                          calls: Optional[dict] = None) -> None:
    """The engine's decode kernel in its KV form launched once per layer
    per decode step and the other decode kernel never; with speculation on
    the fused layer, the verify kernel (kernel 5) in that form once per
    layer per verify burst (never when unfused: the chunk path verifies);
    with ragged prefill the ragged kernel in that form once per layer per
    ragged dispatch.  Kernel 3 never launches on a serving path.  Kernel 7
    launches 225 times per model call under ``--quant`` and never
    otherwise (``check_quant_launches``)."""
    calls = MODEL_CALLS if calls is None else calls
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
    check_quant_launches(engine, launches, calls)


def quant_forms(engine):
    """Kernel 7's form on the engine's (prefill, decode) calls; None for
    bf16 weights."""
    mode = engine.ecfg.quant
    if mode in ("none", ""):
        return None, None
    dec = "w8a8" if engine.mcfg.act_quant else mode
    pre = "w8a8" if engine._prefill_mcfg.act_quant else mode
    return pre, dec


def check_quant_launches(engine, launches: dict, calls: dict) -> None:
    """Kernel 7: once per quantized product — 7 per layer and the head,
    225 per call on llama3-8b — per prefill call (in the prefill config's
    form) and per decode step or verify burst (in the decode config's);
    never on bf16 weights."""
    per_call = 7 * engine.mcfg.n_layers + 1
    pre, dec = quant_forms(engine)
    want = dict.fromkeys(QUANT_FORMS, 0)
    if pre is not None:
        want[pre] += per_call * calls["prefill"]
        want[dec] += per_call * calls["decode"]
        if calls["decode"] == 0:
            raise AssertionError("no decode step ran on a quantized engine")
    got = {f: launches[f"quant_matmul_{f}"] for f in QUANT_FORMS}
    if got != want:
        raise AssertionError(
            f"kernel 7 launches {got} != {per_call} per call x {calls} model calls "
            f"(prefill form {pre}, decode form {dec})")


# ---------------------------------------------------------------------------
# phase 3: the serving path through the tunnel
# ---------------------------------------------------------------------------

class _Tunnel:
    """``run_serve`` + ``run_proxy`` over a loopback channel in front of an
    engine (started by the caller), or of another serve backend (phase
    11d's router); ``async with`` yields the proxy's base URL."""

    def __init__(self, engine, backend=None):
        self.engine = engine
        self.backend = backend

    async def __aenter__(self):
        from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
        from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
        from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
        from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

        self.serve_ch, proxy_ch = loopback_pair()
        ready = asyncio.get_running_loop().create_future()
        self.tasks = [
            asyncio.create_task(run_serve(
                self.serve_ch,
                backend=self.backend or engine_backend(self.engine, MODEL))),
            asyncio.create_task(run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))]
        return f"http://127.0.0.1:{await asyncio.wait_for(ready, 30.0)}"

    async def __aexit__(self, *exc):
        for task in self.tasks:
            task.cancel()
        self.serve_ch.close()
        await asyncio.gather(*self.tasks, return_exceptions=True)


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


def k1_per_wave(cfg, mesh) -> int:
    """Kernel 1's launches a whole-prompt prefill (wave) of model ``cfg``
    under ``mesh``: one a layer, none under ring sequence parallelism (its
    block products are einsums)."""
    ring = mesh is not None and mesh.sp > 1 and cfg.sp_mode == "ring"
    return 0 if ring else cfg.n_layers


async def serve_phase(engine, n_requests: int, max_tokens: int,
                      prompts: Optional[list] = None) -> dict:
    """Concurrent streams through the tunnel (SSE chat and NDJSON generate
    alternating; prompts of 120-400 bytes unless ``prompts`` are given) on
    one engine (phases 3, 6c and 12); checks every stream finished and each
    kernel of the engine's path launched once per layer per prefill wave
    (``k1_per_wave``), decode step or ragged dispatch."""
    waves, steps, dispatches, spec = [0], [0], [0], [0]
    # Waves and ragged dispatches count where this rank runs them (under
    # --dp-dcn, the rows of its own slots).
    prefill_rows, decode_fn, ragged_rows, dispatch_spec = (
        engine._prefill_rows, engine._decode_fn,
        engine._ragged_rows, engine._dispatch_spec)

    def counted_prefill(*a, **kw):
        waves[0] += 1
        return prefill_rows(*a, **kw)

    def counted_decode(*a, **kw):
        steps[0] += a[5]  # (ov_mask, ov_tok, ov_pos, samp, view, steps)
        return decode_fn(*a, **kw)

    def counted_ragged(*a):
        dispatches[0] += 1
        return ragged_rows(*a)

    def counted_spec(**kw):
        spec[0] += 1
        return dispatch_spec(**kw)

    engine._prefill_rows = counted_prefill
    engine._decode_fn = counted_decode
    engine._ragged_rows = counted_ragged
    engine._dispatch_spec = counted_spec

    prompts = prompts or [
        (f"Request {i}: summarise the tunnel design. " * (4 + 3 * i))[: 120 + 40 * i]
        for i in range(n_requests)
    ]
    try:
        async with _Tunnel(engine) as base:
            reset_counters()
            t0 = time.monotonic()
            results = await asyncio.gather(*[
                _stream(base, i, max_tokens, p) for i, p in enumerate(prompts)
            ])
            wall = time.monotonic() - t0
            launches = read_counters()
            calls = dict(MODEL_CALLS)
    finally:
        engine._prefill_rows = prefill_rows
        engine._decode_fn = decode_fn
        engine._ragged_rows = ragged_rows
        engine._dispatch_spec = dispatch_spec
    for r in results:
        if r["tokens"] != max_tokens or r["finish"] != "length":
            raise AssertionError(f"stream ended early: {r}")
    if engine.device.type == "cuda":
        # Under mux with chunked prefill whole-prompt waves are only the
        # echo route: none here.  Under sp mux admits whole-prompt waves.
        per_wave = k1_per_wave(engine.mcfg, engine.mesh)
        if (launches["flash_causal_attention"] != per_wave * waves[0]
                or (waves[0] == 0 and engine.ecfg.prefill_chunk == 0)):
            raise AssertionError(
                f"prefill kernel launches {launches['flash_causal_attention']}"
                f" != {per_wave} x {waves[0]} prefill waves")
        check_engine_launches(engine, launches, steps[0], dispatches[0], spec[0],
                              calls)
    ttfts = [r["ttft"] for r in results]
    return dict(results=results, wall=wall, launches=launches, calls=calls,
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
                 quant=None, fused: bool = False, act_quant: bool = False) -> dict:
    """One prompt's prefill and ``forced`` teacher-forced decode steps
    through the kernel path and through the plain path (every kernel
    wrapper swapped for its plain version, kernel 7's too) on the same
    weights — bf16, or quantized (``act_quant``: W8A8 products) — with a
    ``quant`` KV cache and the unfused or fused decode layer; on an MoE
    config the plain path replays the kernel path's routing."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models import moe
    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    cfg = dataclasses.replace(cfg, fused_decode_layer=fused, act_quant=act_quant)
    dev = params["embed"].device
    kv_dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, 256, (1, prompt_len), generator=g, device=dev)
    forced_toks = torch.randint(0, 256, (forced,), generator=g, device=dev)

    def run():
        cache = tr.init_kv_cache(cfg, 1, 512, dtype=kv_dtype, quant=quant,
                                 device=dev)
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

    swaps = [(tr, "flash_causal_attention", fa.plain),
             (tr, "flash_decode_attention", da.plain),
             (tr, "fused_decode_layer", fd.plain), (qm, "quant_matmul", qm.plain)]
    # MoE: the router's top-k is a discrete function of bf16 activations,
    # so a kernel's rounding can flip a near-tied choice and move a token's
    # MLP output by a whole expert.  The plain path replays the kernel
    # path's routing (the router is plain PyTorch on both paths), so the
    # bound measures the kernels; the unpinned drift and the choices that
    # differ are returned too, not gated.
    routes, route = [], moe.route

    def recorded(*a):
        routes.append(route(*a))
        return routes[-1]

    def replayed(*a):
        want = route(*a)
        got = routes[replayed.calls]
        replayed.calls += 1
        replayed.flips += int(((want > 0) != (got > 0)).sum()) // 2
        return got

    replayed.calls = replayed.flips = 0
    with torch.inference_mode():
        moe.route = recorded
        try:
            kernel = run()
        finally:
            moe.route = route
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            unpinned = run() if cfg.n_experts else None
            moe.route = replayed
            plain = run()
        finally:
            moe.route = route
            for mod, name, fn in saved:
                setattr(mod, name, fn)
    if not torch.isfinite(kernel).all():
        raise AssertionError("kernel-path logits are not finite")
    if replayed.calls != len(routes):
        raise AssertionError(f"the plain path routed {replayed.calls} times, the "
                             f"kernel path {len(routes)}")
    diff = (kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # bf16 activations through 32 layers: each attention output differs by
    # bf16 rounding; bound the drift at 5% of the logits' range.
    limit = 0.05 * scale
    if diff > limit:
        raise AssertionError(
            f"kernel-path logits drift {diff:.4g} > {limit:.4g} from the plain "
            f"path (kv_quant {quant}, fused {fused}, act_quant {act_quant})")
    return dict(max_abs_diff=diff, logit_scale=scale, limit=limit,
                argmax_agree=agree, rows=forced + 1, quant=quant, fused=fused,
                routed=len(routes), flips=replayed.flips,
                unpinned_diff=None if unpinned is None
                else (kernel - unpinned).abs().max().item())


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


async def mux_phase(engine, peers=(), tunnel=None, hit_gate: bool = True,
                    n_conv: int = 0) -> dict:
    """``n_conv`` (default ``N_CONV``, 8) two-turn conversations through the
    tunnel on a serving engine (phases 5-10, 13); the kernel checks follow
    the engine's KV form, decode kernel and ragged switch, kernel 1 once
    per layer per whole-prompt wave (waves and ragged dispatches counted
    where this rank runs them); on an engine with the prefix pool (the
    serve defaults) its counters rose and (``hit_gate``) each second turn
    hit its first turn's answer.  ``tunnel`` (default:
    ``_Tunnel(engine)``) fronts the engines; the dispatches of ``peers``
    (engines of the same form behind it) count toward the launch checks
    too."""
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    waves, dispatches, steps, spec, hist_of = [0], [0], [0], [0], {}
    pool = engine._prefix
    match = pool.match if pool is not None else None
    n_conv = n_conv or N_CONV
    wrapped = ("_prefill_rows", "_ragged_rows", "_decode_fn", "_dispatch_spec")
    saved = [(e, {n: getattr(e, n) for n in wrapped}) for e in (engine, *peers)]

    def counted(tally, fn, n=lambda a: 1):
        def call(*a, **kw):
            tally[0] += n(a)
            return fn(*a, **kw)
        return call

    for e, fns in saved:
        e._prefill_rows = counted(waves, fns["_prefill_rows"])
        e._ragged_rows = counted(dispatches, fns["_ragged_rows"])
        e._decode_fn = counted(steps, fns["_decode_fn"], lambda a: a[5])
        e._dispatch_spec = counted(spec, fns["_dispatch_spec"])

    def recorded_match(prompt_ids):
        hist, ids = match(prompt_ids)
        key = tuple(prompt_ids)
        hist_of[key] = max(hist_of.get(key, 0), hist)
        return hist, ids

    if pool is not None:
        pool.match = recorded_match
    counters = ("engine_prefix_hit_tokens_total",
                "engine_prefix_dedup_hits_total",
                "engine_conv_saved_pages_total", "engine_conv_hits_total",
                "engine_spec_proposed_tokens_total",
                "engine_spec_accepted_tokens_total")
    system = list(SYSTEM_PROMPT.encode())
    firsts = [system + list(f"Turn one of conversation {i}: how does the "
                            f"tunnel carry request {i}? ".encode() * (1 + i % 2))
              for i in range(n_conv)]
    try:
        async with (tunnel or _Tunnel(engine)) as base:
            before = {c: global_metrics.counter(c) for c in counters}
            reset_counters()
            t0 = time.monotonic()
            one = await asyncio.gather(*[
                _conv_turn(base, p, TURN1_TOKENS, ndjson=i % 2 == 1)
                for i, p in enumerate(firsts)])
            seconds = [p + r["ids"] + list(b" And what happens next?")
                       for p, r in zip(firsts, one)]
            t_two = time.monotonic()
            two = await asyncio.gather(*[
                _conv_turn(base, p, TURN2_TOKENS, ndjson=False) for p in seconds])
            wall = time.monotonic() - t0
            launches = read_counters()
            calls = dict(MODEL_CALLS)
            deltas = {c: global_metrics.counter(c) - before[c] for c in counters}
    finally:
        for e, fns in saved:
            for n, fn in fns.items():
                setattr(e, n, fn)
        if pool is not None:
            pool.match = match
    for r, want in zip(one + two, [TURN1_TOKENS] * n_conv + [TURN2_TOKENS] * n_conv):
        if len(r["ids"]) != want or r["finish"] != "length":
            raise AssertionError(f"conversation stream ended early: {r}")
    sys_pages = len(system) // 16 * 16
    if pool is not None:
        for name in counters[:3]:
            if deltas[name] <= 0:
                raise AssertionError(f"{name} did not rise: {deltas}")
        for i, (p1, p2) in enumerate(zip(firsts, seconds) if hit_gate else ()):
            hist = hist_of.get(tuple(p2), 0)
            # Past the system prompt AND past turn 1's prompt pages: into
            # the answer's conversation-cache pages.
            if hist <= sys_pages or hist < len(p1) // 16 * 16 + 16:
                raise AssertionError(
                    f"conversation {i}: turn-2 hit {hist} tokens does not reach "
                    f"past the system prompt ({sys_pages}) into turn 1's answer "
                    f"(turn 1 prompt {len(p1)} tokens)")
        if engine._page_reserved or pool.reserved_pages:
            raise AssertionError("pool pages still reserved after every stream ended")
    if (engine.device.type == "cuda"
            and launches["flash_causal_attention"] != engine.mcfg.n_layers * waves[0]):
        raise AssertionError(
            f"prefill kernel launches {launches['flash_causal_attention']} != "
            f"{engine.mcfg.n_layers} x {waves[0]} prefill waves")
    check_engine_launches(engine, launches, steps[0], dispatches[0], spec[0],
                          calls)
    ttfts = [r["ttft"] for r in one + two]
    return dict(one=one, two=two, seconds=seconds, t_two=t_two, wall=wall,
                launches=launches, calls=calls,
                waves=waves[0], dispatches=dispatches[0], steps=steps[0], spec=spec[0],
                deltas=deltas,
                hists=[hist_of.get(tuple(p), 0) for p in seconds],
                sys_pages=sys_pages,
                tok_s=sum(len(r["ids"]) for r in one + two) / wall,
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                ttft_max_ms=max(ttfts) * 1e3,
                turn1_ttft_p50_ms=statistics.median(r["ttft"] for r in one) * 1e3,
                turn2_ttft_p50_ms=statistics.median(r["ttft"] for r in two) * 1e3)


def decode_launches(engine, steps: int = 4):
    """``--profile``: CUDA kernels (and copies) the model launches per
    decode step — per verify burst of SPEC_T tokens on a speculating engine
    — on this engine's weights and cache, every slot live at position 200,
    view 256, no sampling, counted by torch.profiler; and kernel 7's device
    ms per step (0 on bf16 weights)."""
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
    launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return launches / steps, k7_device_ms(prof) / steps


def k7_device_ms(prof) -> float:
    """Kernel 7's device ms in a torch.profiler window: both plans and
    W8A8's quantizer."""
    return sum(dev_us(e) for e in prof.key_averages()
               if any(n in e.key for n in K7_KERNELS)) / 1e3


def k7_call_ms(engine, steps: int = 4) -> dict:
    """Kernel 7's device ms per decode step (every slot live at position
    200, view 256) and per prefill call (one ragged dispatch of the phase-2
    group, TOT 1024 flat tokens: its projections at M 1024 and the head at
    its 8 sampled rows) on this engine's weights and cache, by
    torch.profiler, with the products each call launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    rows = engine.ecfg.num_slots + 1
    toks = torch.ones((rows,), dtype=torch.long, device=engine.device)
    pos = torch.full((rows,), 200, dtype=torch.int32, device=engine.device)
    entries = [(i, st, ln) for i, (st, ln) in enumerate(RAGGED_ROWS)]
    slot_of, start_of, qoff_of, _qlen, base_of, offs = pa.plan_ragged_group(
        entries, 16, RAGGED_TOT, scratch_slot=rows - 1)
    descs = [torch.tensor(x, dtype=torch.int32, device=engine.device)
             for x in (slot_of, start_of, qoff_of, base_of)]
    sample = torch.tensor([o + ln - 1 for (_, _, ln), o in zip(entries, offs)],
                          dtype=torch.int32, device=engine.device)
    flat = torch.ones((RAGGED_TOT,), dtype=torch.long, device=engine.device)

    def decode():
        tr.decode_step(engine.mcfg, engine.params, engine.kv_cache, toks, pos,
                       kv_view=256)

    def prefill():
        tr.ragged_prefill_into_cache(engine.mcfg, engine.params, flat, *descs,
                                     sample, engine.kv_cache, 16)

    out = {}
    with torch.inference_mode():
        for kind, fn, n in (("decode", decode, steps), ("prefill", prefill, 2)):
            fn()
            torch.cuda.synchronize()
            before = qm.quant_matmul.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            out[f"{kind}_ms"] = k7_device_ms(prof) / n
            out[f"{kind}_products"] = (qm.quant_matmul.launches - before) / n
    return out


def cli_engine(params, cfg, *flags, model: str = MODEL, depth_cut: bool = False,
               fences=()):
    """The engine ``tunnel-gpu serve --backend gpu`` builds from ``flags``
    (16 slots, 1024 positions), on the given weights (None: the engine's
    own random init from seed 0 — directly quantized under ``--quant`` —
    or the ``--ckpt`` file); ``depth_cut`` serves ``cfg`` itself, the
    preset at fewer layers.  The engine must fence exactly the knobs
    ``fences`` names, in order (none by default)."""
    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer

    ecfg = cli._engine_config(cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", model,
        "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ), *flags]))
    engine = InferenceEngine(model_cfg=cfg if depth_cut else None, engine_cfg=ecfg,
                             params=params,
                             tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size),
                             device=DEVICE)
    if [f["knob"] for f in engine.config_fences] != list(fences):
        raise AssertionError(f"engine {flags} fenced {engine.config_fences}, "
                             f"not {list(fences)}")
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
                out["launches_per_step"], out["k7_ms_per_step"] = decode_launches(engine)
            return t_ready, out
        finally:
            await engine.stop()

    return asyncio.run(drive())


def stream_bound_ms(engine) -> float:
    """The least time one decode step could take to stream the engine's
    projection and head weights (packed bytes and scales) at 3.35 TB/s."""
    from p2p_llm_tunnel_tpu_torch.models.quant import weight_bytes

    p = engine.params
    head = p["embed"] if engine.mcfg.tie_embeddings else p["lm_head"]
    return (weight_bytes(p["blocks"]) + weight_bytes(head)) / PEAK_HBM_BYTES * 1e3


def print_quant_launches(tag: str, run: dict, engine) -> None:
    pre, dec = quant_forms(engine)
    per_call = 7 * engine.mcfg.n_layers + 1
    k7 = {f: run["launches"][f"quant_matmul_{f}"] for f in QUANT_FORMS}
    print(f"{tag} kernel 7 launches {k7} = {per_call} per call x "
          f"{run['calls']['prefill']} prefill calls ({pre}) + "
          f"{run['calls']['decode']} decode steps / verify bursts ({dec})")


def free_engine(engine) -> None:
    """Drop an engine's device state (cache, pool) before the next is built,
    and the flight recorder's hold on the engine (it keeps the last engine
    built registered, and with it that engine's weights)."""
    import gc

    import torch

    from p2p_llm_tunnel_tpu_torch.utils.flight import global_blackbox

    engine.kv_cache = None
    engine._pool = None
    global_blackbox.set_engine_provider(None)
    gc.collect()
    torch.cuda.empty_cache()


def print_mux(tag: str, engine, mux: dict, t_ready: float, name: str) -> None:
    ec = engine.ecfg
    wq = "bf16" if ec.quant in ("none", "") else (
        f"--quant {ec.quant}" + (f" g{ec.quant_group_size}" if ec.quant == "int4" else "")
        + (" --prefill-act-quant" if ec.prefill_act_quant else ""))
    print(f"{tag} {MODEL} {wq} serve-CLI defaults (mux {ec.mux}, prefix cache "
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
        if ec.quant not in ("none", ""):
            print(f"{tag} profile: kernel 7 device {mux['k7_ms_per_step']:.4f} ms per "
                  f"{what} against the weight-stream bound "
                  f"{stream_bound_ms(engine):.4f} ms ({name})")


# ---------------------------------------------------------------------------
# phase 9: embeddings, mixture-of-experts, checkpoints
# ---------------------------------------------------------------------------

#: Tolerance of a pooled embedding against another of the same input (the
#: input alone, or kernel 1's plain version): unit vectors of bf16
#: activations through 32 layers, compared by cosine similarity.
EMBED_MIN_COS = 0.999
#: Phase 9b: mixtral-8x7b's widths at 8 of its 32 layers (8 x 2.9 GB of
#: bf16 experts and attention, + 0.5 GB embedding and head: 23.5 GB; 32
#: layers, ~93 GB, do not fit one 80 GB card in either package's forms).
MOE_MODEL, MOE_LAYERS = "mixtral-8x7b", 8
#: Phase 9c: llama3-8b's widths at 2 of its 32 layers (a 3 GB file).
CKPT_LAYERS = 2
CKPT_DIR = "build/chip_smoke_ckpt"


async def _post_json(base: str, path: str, payload: dict):
    from p2p_llm_tunnel_tpu_torch.endpoints import http11

    t0 = time.monotonic()
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(payload).encode(), timeout=600.0)
    body = await resp.read_all()
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}: {body[:200]!r}")
    return json.loads(body), (time.monotonic() - t0) * 1e3


def _cos(a, b) -> float:
    import numpy as np

    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


async def embed_phase(engine) -> dict:
    """[9a] Embeddings through the tunnel on a serving engine: one
    /v1/embeddings request of ``prefill_rows + 1`` inputs of different
    lengths (two sub-batches), each input again alone, and /api/embed;
    checks the width, unit norms, each vector against the input embedded
    alone and /api/embed against /v1/embeddings (cosine >=
    ``EMBED_MIN_COS``), kernel 1 once per layer per sub-batch, and the
    first sub-batch's vectors against ``encode_pooled`` with kernel 1's
    plain version on the card (real rows only: a pad row sees no key)."""
    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    rows = engine.ecfg.prefill_rows
    texts = [(f"Embedding input {i}: the tunnel carries each request across. "
              * (1 + i))[: 24 + 90 * i] for i in range(rows + 1)]
    encode, batches = engine._encode, []

    def recorded(tokens, valid):
        batches.append((tokens, valid))
        return encode(tokens, valid)

    engine._encode = recorded
    try:
        async with _Tunnel(engine) as base:
            reset_counters()
            obj, batch_ms = await _post_json(base, "/v1/embeddings", {"input": texts})
            n_batch = len(batches)
            launches = read_counters()
            vecs = np.array([d["embedding"] for d in obj["data"]], np.float64)
            singles, single_ms = [], []
            for t in texts:
                one, ms = await _post_json(base, "/v1/embeddings", {"input": t})
                singles.append(one["data"][0]["embedding"])
                single_ms.append(ms)
            ollama, ollama_ms = await _post_json(base, "/api/embed", {"input": texts[:2]})
    finally:
        engine._encode = encode
    dim = engine.mcfg.dim
    if vecs.shape != (rows + 1, dim) or n_batch != 2:
        raise AssertionError(f"[9a] {vecs.shape} vectors from {n_batch} sub-batches")
    norms = np.linalg.norm(vecs, axis=-1)
    if np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"[9a] norms {norms}")
    alone = min(_cos(v, s) for v, s in zip(vecs, singles))
    via_ollama = min(_cos(v, s) for v, s in zip(vecs, ollama["embeddings"]))
    if min(alone, via_ollama) < EMBED_MIN_COS:
        raise AssertionError(f"[9a] cosine to the input alone {alone}, /api/embed "
                             f"{via_ollama} < {EMBED_MIN_COS}")
    if (engine.device.type == "cuda"
            and launches["flash_causal_attention"] != engine.mcfg.n_layers * n_batch):
        raise AssertionError(f"[9a] kernel 1 launches {launches['flash_causal_attention']}"
                             f" != {engine.mcfg.n_layers} x {n_batch} sub-batches")
    # The first sub-batch again, kernel 1 against its plain version.
    tokens, valid = batches[0]
    t = torch.from_numpy(tokens).to(engine.device)
    v = torch.from_numpy(valid).to(engine.device)
    real = valid.any(axis=1)
    with torch.inference_mode():
        kernel = tr.encode_pooled(engine.mcfg, engine.params, t, v).cpu().numpy()
        saved = tr.flash_causal_attention
        tr.flash_causal_attention = fa.plain
        try:
            plain = tr.encode_pooled(engine.mcfg, engine.params, t, v).cpu().numpy()
        finally:
            tr.flash_causal_attention = saved
    vs_plain = min(_cos(a, b) for a, b in zip(kernel[real], plain[real]))
    if vs_plain < EMBED_MIN_COS:
        raise AssertionError(f"[9a] kernel vs plain cosine {vs_plain} < {EMBED_MIN_COS}")
    return dict(inputs=len(texts), dim=dim, layers=engine.mcfg.n_layers,
                widths=[b[0].shape for b in batches[:2]],
                batch_ms=batch_ms, single_ms=statistics.median(single_ms),
                ollama_ms=ollama_ms, alone_cos=alone, ollama_cos=via_ollama,
                plain_cos=vs_plain, plain_max_abs=float(np.abs(kernel[real] -
                                                               plain[real]).max()),
                launches=launches, seconds=time.monotonic() - t_start,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


async def mux_embed_phase(engine) -> dict:
    """Phase 5's conversations, then [9a] on the same engine."""
    out = await mux_phase(engine)
    out["embed"] = await embed_phase(engine)
    return out


def print_embed(em: dict, name: str) -> None:
    print(f"[9a] {MODEL} ({em['dim']} dims, {em['layers']} layers) on phase 5's engine: "
          f"/v1/embeddings of {em['inputs']} inputs in {em['widths'][0][0]}-row "
          f"sub-batches of widths {[w[1] for w in em['widths']]}: {em['batch_ms']:.1f} ms; "
          f"one input alone {em['single_ms']:.1f} ms (median); /api/embed of 2 "
          f"{em['ollama_ms']:.1f} ms ({name}; client side through the tunnel)")
    print(f"[9a] unit norms; min cosine to the input alone {em['alone_cos']:.6f}, "
          f"/api/embed to /v1/embeddings {em['ollama_cos']:.6f}, kernel 1 to its "
          f"plain version {em['plain_cos']:.6f} (max |diff| {em['plain_max_abs']:.3e}; "
          f"real rows; tolerance cosine >= {EMBED_MIN_COS}); phase {em['seconds']:.1f} s, "
          f"peak memory {em['peak_gb']:.3f} GB ({name})")


def moe_phase(name: str, add_launches) -> None:
    """[9b] mixtral-8x7b's widths at MOE_LAYERS layers: random bf16 weights
    from seed 0 on the card; kernel-vs-plain logits (raw cache with kernel
    2, int4 cache with kernel 4); the 8 two-turn conversations on the plain
    loop and on the serve defaults + --ragged-prefill; short streams with
    --kv-quant int4 --fused-decode-layer and with speculation."""
    import torch

    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.quant import weight_bytes

    full = get_config(MOE_MODEL)
    cfg = get_config(MOE_MODEL, n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = tr.init_params(cfg, 0, torch.bfloat16, DEVICE)
    torch.cuda.synchronize()
    print(f"[9b] {MOE_MODEL} widths (dim {cfg.dim}, ffn {cfg.ffn_dim}, "
          f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, vocab {cfg.vocab_size}); "
          f"reduced: depth {MOE_LAYERS} of {full.n_layers} layers; weights "
          f"{weight_bytes(params) / 1e9:.3f} GB bf16 from seed 0 in "
          f"{time.monotonic() - t0:.1f} s")
    for quant, fused in ((None, False), ("int4", True)):
        lg = logits_phase(cfg, params, quant=quant, fused=fused)
        print(f"[9b] logits, kv_quant {quant}, fused decode layer {fused}: prefill + "
              f"{lg['rows'] - 1} teacher-forced decode steps, the plain path on the "
              f"kernel path's routing: max |kernel - plain| {lg['max_abs_diff']:.4g} "
              f"(limit {lg['limit']:.4g} = 5% of max |logit| {lg['logit_scale']:.4g}), "
              f"argmax agreement {lg['argmax_agree']:.2f}; unpinned (printed, not "
              f"gated): {lg['flips']} of the top-{cfg.n_experts_per_tok} choices differ "
              f"over {lg['routed']} router calls, max |diff| {lg['unpinned_diff']:.4g}")
    tok = NumericTokenizer(vocab_size=cfg.vocab_size)
    plain = InferenceEngine(model_cfg=cfg, engine_cfg=EngineConfig(
        model=MOE_MODEL, num_slots=NUM_SLOTS, max_seq=MAX_SEQ, dtype="bfloat16"),
        params=params, tokenizer=tok, device=DEVICE)
    t_ready, served = run_engine(plain, mux_phase)
    add_launches(served["launches"])
    print(f"[9b] plain loop: ready in {t_ready:.1f} s; {N_CONV} conversations x 2 "
          f"turns ({TURN1_TOKENS} + {TURN2_TOKENS} tokens), {served['waves']} prefill "
          f"waves, {served['steps']} decode steps; {served['tok_s']:.1f} tok/s, TTFT "
          f"p50 {served['ttft_p50_ms']:.1f} ms ({name}); launch counts "
          f"{ {k: v for k, v in served['launches'].items() if v} }")
    free_engine(plain)
    del plain
    mux = cli_engine(params, cfg, "--ragged-prefill", model=MOE_MODEL, depth_cut=True)
    t_ready, m = run_engine(mux, mux_phase)
    add_launches(m["launches"])
    print(f"[9b] serve defaults + --ragged-prefill: ready in {t_ready:.1f} s; "
          f"{N_CONV} conversations x 2 turns ({TURN1_TOKENS} + {TURN2_TOKENS} tokens); "
          f"{m['tok_s']:.1f} tok/s, TTFT p50 {m['ttft_p50_ms']:.1f} ms (turn 2 p50 "
          f"{m['turn2_ttft_p50_ms']:.1f} ms; {name}); ragged dispatches "
          f"{m['dispatches']}, decode steps {m['steps']}, counters {m['deltas']}")
    free_engine(mux)
    del mux
    for flags in (("--kv-quant", "int4", "--fused-decode-layer"),
                  ("--spec-ngram", "3", "--spec-k", "4")):
        e = cli_engine(params, cfg, *flags, model=MOE_MODEL, depth_cut=True)
        t_ready, short = run_engine(e, lambda e: serve_phase(e, 4, 16))
        if "--spec-ngram" in flags and short["spec"] <= 0:
            raise AssertionError("[9b] no verify burst ran")
        add_launches(short["launches"])
        print(f"[9b] {' '.join(flags)}: ready in {t_ready:.1f} s; 4 streams x 16 "
              f"tokens, {short['steps']} decode steps, {short['spec']} verify bursts; "
              f"{short['tok_s']:.1f} tok/s, TTFT p50 {short['ttft_p50_ms']:.1f} ms "
              f"({name}); launch counts "
              f"{ {k: v for k, v in short['launches'].items() if v} }")
        free_engine(e)
        del e
    print(f"[9b] peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({name})")
    del params
    torch.cuda.empty_cache()


def hf_state_on_card(cfg, seed: int = 0) -> dict:
    """An HF llama state dict (scripts/make_synth_hf_ckpt.py's key layout and
    ``[out, in]`` orientation) of bf16 normals x 0.02 from ``seed``, drawn
    on the card."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=g, device=DEVICE, dtype=torch.bfloat16) * 0.02

    def ones():
        return torch.ones(cfg.dim, device=DEVICE, dtype=torch.bfloat16)

    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    state = {"model.embed_tokens.weight": w(cfg.vocab_size, cfg.dim),
             "model.norm.weight": ones(), "lm_head.weight": w(cfg.vocab_size, cfg.dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        state.update({
            p + "input_layernorm.weight": ones(),
            p + "post_attention_layernorm.weight": ones(),
            p + "self_attn.q_proj.weight": w(q, cfg.dim),
            p + "self_attn.k_proj.weight": w(kv, cfg.dim),
            p + "self_attn.v_proj.weight": w(kv, cfg.dim),
            p + "self_attn.o_proj.weight": w(cfg.dim, q),
            p + "mlp.gate_proj.weight": w(cfg.ffn_dim, cfg.dim),
            p + "mlp.up_proj.weight": w(cfg.ffn_dim, cfg.dim),
            p + "mlp.down_proj.weight": w(cfg.dim, cfg.ffn_dim)})
    return state


async def greedy_ids(engine, prompts, max_tokens: int) -> list:
    """Greedy streams through the tunnel, one request at a time (so every
    batch the engine runs is the same from one engine to the next)."""
    await engine.start()
    try:
        await engine.warmup()
        async with _Tunnel(engine) as base:
            return [(await _conv_turn(base, p, max_tokens, ndjson=i % 2 == 1))["ids"]
                    for i, p in enumerate(prompts)]
    finally:
        await engine.stop()


def ckpt_phase(name: str, add_launches) -> None:
    """[9c] llama3-8b's widths at CKPT_LAYERS layers: an HF state dict from
    seed 0 -> ``convert_hf("llama")`` -> ``save_checkpoint`` under build/
    -> an engine built from the serve flags with ``--ckpt``; its greedy
    streams through the tunnel byte-identical to an engine injected with
    the converted weights (same kernels, same order, one card)."""
    import os
    import shutil

    import torch

    from p2p_llm_tunnel_tpu_torch.models import checkpoint as ck
    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    full = get_config(MODEL)
    cfg = get_config(MODEL, n_layers=CKPT_LAYERS)
    t0 = time.monotonic()
    state = hf_state_on_card(cfg)
    params = ck.convert_hf("llama", state, cfg, torch.bfloat16, device=DEVICE)
    del state
    torch.cuda.synchronize()
    t_conv = time.monotonic() - t0
    t0 = time.monotonic()
    ck.save_checkpoint(CKPT_DIR, params)
    t_save = time.monotonic() - t0
    nbytes = os.path.getsize(os.path.join(CKPT_DIR, ck.CKPT_FILE))
    prompts = [list(f"Checkpoint stream {i}: what did the tunnel load? ".encode())
               * (1 + i) for i in range(4)]
    try:
        t0 = time.monotonic()
        loaded = cli_engine(None, cfg, "--ckpt", CKPT_DIR, depth_cut=True)
        t_load = time.monotonic() - t0
        for key, got in loaded.params["blocks"].items():
            if not torch.equal(got, params["blocks"][key]):
                raise AssertionError(f"[9c] loaded leaf blocks/{key} differs")
        reset_counters()
        got = asyncio.run(greedy_ids(loaded, prompts, 16))
        add_launches(read_counters())
        free_engine(loaded)
        del loaded
        injected = cli_engine(params, cfg, depth_cut=True)
        want = asyncio.run(greedy_ids(injected, prompts, 16))
        free_engine(injected)
        del injected
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if got != want or any(len(ids) != 16 for ids in got):
        raise AssertionError(f"[9c] --ckpt streams {got} != injected {want}")
    print(f"[9c] {MODEL} widths; reduced: depth {CKPT_LAYERS} of {full.n_layers} "
          f"layers; HF state from seed 0 converted in {t_conv:.1f} s; "
          f"save_checkpoint {nbytes} bytes in {t_save:.1f} s; engine from the serve "
          f"flags with --ckpt built (load + init) in {t_load:.1f} s ({name}); "
          f"4 greedy streams x 16 tokens through the tunnel byte-identical to the "
          f"injected engine's")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the prefix pool's host-RAM spill tier, pool snapshots and
# KV_PAGES prefill/decode disaggregation, at llama3-8b's full width
# ---------------------------------------------------------------------------

SPILL_PAGES = 256
#: The spill engines' pool: below the conversations' working set (printed),
#: so pages must leave the pool and come back.
SPILL_POOL_BLOCKS = 84
SNAPSHOT_DIR = "build/chip_smoke_snapshot"
#: Full pool pages of the shared system prompt.
SYS_BLOCKS = len(SYSTEM_PROMPT.encode()) // 16
#: Conversations whose second turn must take history through page-ins.
MIN_PAGED_IN_CONVS = 4
#: New conversations of the shared system prompt: the last request 10a's
#: engine serves before it stops and saves, and 10b's first request.
SYSTEM_QUESTIONS = (" One more question before the restart?",
                    " A new conversation: what is a page?")


async def system_turn(engine, question: str, max_tokens: int) -> dict:
    """One new conversation of the shared system prompt through the tunnel
    (the engine started by the caller); returns its stream and the pool
    hit of its first match."""
    pi, hits = engine._prefix, []
    match = pi.match

    def first_match(prompt_ids):
        out = match(prompt_ids)
        hits.append(out[0])
        return out

    pi.match = first_match
    try:
        async with _Tunnel(engine) as base:
            r = await _conv_turn(base, list((SYSTEM_PROMPT + question).encode()),
                                 max_tokens, ndjson=False)
    finally:
        pi.match = match
    if not hits or len(r["ids"]) != max_tokens:
        raise AssertionError(f"system-prompt request: hits {hits}, {r}")
    return dict(r, hit=hits[0])


class SpillProbe:
    """An engine's page copies, instrumented for one phase (executor
    thread): the ms and pages of each page-out and page-in batch (the
    engine's own copies, checksums and verification included), the time
    each page spliced, and a re-export of every spliced page right after
    its splice, held against the checksum it carried (a page-out's, or
    the sender's for a KV_PAGES transfer).  On a decode peer it also
    counts each transfer's pages: offered, and already resident (a page
    the receiver holds is skipped, not spliced)."""

    def __init__(self, engine):
        self.engine = engine
        self.out_batches, self.in_batches = [], []
        self.spliced = []  # (monotonic time, key)
        self.checked, self.mismatched = 0, []
        self.offered = self.resident = 0
        self.import_ms = []
        self._orig = (engine._spill_copy_out, engine._spill_copy_in,
                      engine.import_kv_pages)
        engine._spill_copy_out = self._copy_out
        engine._spill_copy_in = self._copy_in
        engine.import_kv_pages = self._import

    def restore(self) -> None:
        e = self.engine
        e._spill_copy_out, e._spill_copy_in, e.import_kv_pages = self._orig

    def _copy_out(self, plan):
        t0 = time.monotonic()
        out = self._orig[0](plan)
        self.out_batches.append(((time.monotonic() - t0) * 1e3, len(plan)))
        return out

    def _copy_in(self, items):
        from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import (
            page_checksum,
            page_out,
        )

        t0 = time.monotonic()
        results = self._orig[1](items)
        self.in_batches.append(((time.monotonic() - t0) * 1e3, len(items)))
        want = {key: page.checksum for key, _idx, page in items}
        for key, idx, ok in results:
            if not ok:
                continue
            self.spliced.append((time.monotonic(), key))
            self.checked += 1
            if page_checksum(page_out(self.engine._pool, idx)) != want[key]:
                self.mismatched.append(key.hex())
        return results

    async def _import(self, meta, pages, blobs):
        pi = self.engine._prefix
        self.offered += len(pages)
        self.resident += sum(1 for spec in pages
                             if pi.id_of(bytes.fromhex(str(spec["key"]))) is not None)
        t0 = time.monotonic()
        try:
            return await self._orig[2](meta, pages, blobs)
        finally:
            self.import_ms.append((time.monotonic() - t0) * 1e3)

    @staticmethod
    def per_page(batches) -> float:
        pages = sum(n for _, n in batches)
        return sum(ms for ms, _ in batches) / pages if pages else float("nan")


def divergence(a_runs, b_runs) -> list:
    """Tokens before the first difference, per stream."""
    out = []
    for a, b in zip(a_runs, b_runs):
        out.append(next((i for i, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y),
                        min(len(a["ids"]), len(b["ids"]))))
    return out


def page_costs(engine, idx: int = 1, reps: int = 5) -> dict:
    """Median ms of one pool page's parts of a spill copy, on this
    engine's pool (the engine stopped): the card-to-host copies
    (``page_out``), the checksum over them, and the host-to-card copies
    (``page_in``, writing the slot's own bytes back)."""
    from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import (
        page_checksum,
        page_in,
        page_out,
    )

    pool = engine._pool
    payload = page_out(pool, idx)
    parts = {"page_out": lambda: page_out(pool, idx),
             "checksum": lambda: page_checksum(payload),
             "page_in": lambda: page_in(pool, idx, payload)}
    out = {}
    for part, fn in parts.items():
        times = []
        for _ in range(reps):
            t0 = time.monotonic()
            fn()
            if engine.device.type == "cuda":
                import torch

                torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        out[part] = statistics.median(times)
    return out


def spill_run(tag: str, params, cfg, flags, name: str, ref: dict, add_launches,
              snapshot: bool = False):
    """[10a] Phase 5's conversations on the serve defaults + ragged prefill
    + ``--spill-pages`` with a pool below their working set (``snapshot``:
    then one new conversation of the system prompt, before the engine
    stops and saves its pool); returns the stopped engine, the run and the
    save's seconds."""
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    engine = cli_engine(params, cfg, "--ragged-prefill", "--spill-pages",
                        str(SPILL_PAGES), "--prefix-pool-blocks",
                        str(SPILL_POOL_BLOCKS), *flags)
    pi = engine._prefix
    probe = SpillProbe(engine)
    save_s = []
    save = engine.save_prefix_snapshot

    def timed_save():
        t0 = time.monotonic()
        save()
        save_s.append(time.monotonic() - t0)

    engine.save_prefix_snapshot = timed_save
    before = {c: global_metrics.counter(c) for c in
              ("engine_spill_pageouts_total", "engine_spill_pageins_total",
               "engine_spill_pagein_failures_total")}
    async def phase(e):
        m = await mux_phase(e, hit_gate=False)
        if snapshot:
            m["last"] = await system_turn(e, SYSTEM_QUESTIONS[0], 4)
        return m

    try:
        t_ready, m = run_engine(engine, phase)
    finally:
        probe.restore()
        engine.save_prefix_snapshot = save
    deltas = {c: global_metrics.counter(c) - v for c, v in before.items()}
    costs = page_costs(engine)
    wanted = len({k for p in m["seconds"] for k in pi._keys_of(p)})
    paged = {k for t, k in probe.spliced if t >= m["t_two"]}
    convs = [i for i, p in enumerate(m["seconds"])
             if paged & set(pi._keys_of(p)[SYS_BLOCKS:])]
    print_mux(tag, engine, m, t_ready, name)
    print(f"{tag} pool {SPILL_POOL_BLOCKS} blocks (page {engine._prefix_block_bytes} "
          f"bytes) against {wanted} blocks the conversations want; spill tier "
          f"{SPILL_PAGES} pages; page-outs {pi.spill_pageouts}, page-ins "
          f"{pi.spill_pageins}, tier drops {pi.spill_drops}, evictions "
          f"{pi.evictions}; counters {deltas}")
    print(f"{tag} page-out {SpillProbe.per_page(probe.out_batches):.3f} ms a page "
          f"({sum(n for _, n in probe.out_batches)} pages in "
          f"{len(probe.out_batches)} batches), page-in "
          f"{SpillProbe.per_page(probe.in_batches):.3f} ms a page "
          f"({sum(n for _, n in probe.in_batches)} pages in "
          f"{len(probe.in_batches)} batches), copy + checksum + verify on the "
          f"engine's executor; one page alone, median of 5: page_out "
          f"{costs['page_out']:.3f} ms, checksum {costs['checksum']:.3f} ms, "
          f"page_in {costs['page_in']:.3f} ms ({name})")
    print(f"{tag} host tier {pi.spill_resident} pages = "
          f"{pi.spill_resident * engine._prefix_block_bytes} bytes; turn-2 "
          f"conversations with history paged in: {convs}; turn-2 pool hits "
          f"{m['hists']} tokens; {probe.checked} spliced pages re-exported "
          f"with their page-out checksum")
    print(f"{tag} tokens before the first divergence from the same engine with "
          f"the tier off (phase {5 if engine.ecfg.kv_quant == 'none' else '6a'}), per stream (turn 1, then turn 2; printed, not required: "
          f"recomputed and spliced KV run through other batches on the card): "
          f"{divergence(m['one'] + m['two'], ref['one'] + ref['two'])}")
    if snapshot:
        print(f"{tag} then a new conversation of the system prompt: pool hit "
              f"{m['last']['hit']} tokens, ttft {m['last']['ttft'] * 1e3:.1f} ms; "
              f"{pi.used_blocks} blocks resident at stop")
    if pi.spill_pageouts <= 0 or deltas["engine_spill_pageins_total"] <= 0:
        raise AssertionError(f"{tag} the tier moved no pages: {deltas}")
    if len(convs) < MIN_PAGED_IN_CONVS:
        raise AssertionError(f"{tag} only conversations {convs} took turn-2 history "
                             f"through page-ins (want {MIN_PAGED_IN_CONVS})")
    if probe.mismatched or probe.checked != pi.spill_pageins:
        raise AssertionError(f"{tag} {probe.checked} re-exports of {pi.spill_pageins} "
                             f"page-ins; checksum mismatches {probe.mismatched}")
    if engine._spill_inflight or global_metrics.gauge("engine_spill_inflight"):
        raise AssertionError(f"{tag} spill copies still in flight after the drain")
    add_launches(m["launches"])
    return engine, m, save_s


def snapshot_phase(params, cfg, flags, save_s: float, name: str) -> None:
    """[10b] A fresh engine from 10a's flags restores the pool 10a's engine
    saved at stop: its checksum is the saved one, the first request of the
    shared system prompt hits every system-prompt page before any
    prefill; an engine at ``--kv-quant int8`` on the directory starts cold."""
    import os

    from p2p_llm_tunnel_tpu_torch.engine import engine as em
    from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import page_checksum, to_host

    files = {f: os.path.getsize(os.path.join(SNAPSHOT_DIR, f))
             for f in ("prefix_pool.npz", "prefix_index.json")}
    with open(os.path.join(SNAPSHOT_DIR, "prefix_index.json")) as f:
        saved = json.load(f)
    load, load_s = em.load_pool_snapshot, []

    def timed_load(*a):
        t0 = time.monotonic()
        out = load(*a)
        load_s.append(time.monotonic() - t0)
        return out

    em.load_pool_snapshot = timed_load
    try:
        warm = cli_engine(params, cfg, "--ragged-prefill", "--spill-pages",
                          str(SPILL_PAGES), "--prefix-pool-blocks",
                          str(SPILL_POOL_BLOCKS), *flags)
    finally:
        em.load_pool_snapshot = load
    pi = warm._prefix
    restored = page_checksum({k: to_host(v) for k, v in warm._pool.items()}).hex()
    restored_blocks = pi.used_blocks
    if restored_blocks == 0 or restored != saved["pool_checksum"]:
        raise AssertionError(f"[10b] restored {restored_blocks} blocks, checksum "
                             f"{restored} vs saved {saved['pool_checksum']}")
    # The restored index answers the system prompt before any request: the
    # request's own admission first reserves pool pages for its insert, and
    # in a full pool that eviction takes the cheapest pages, which are the
    # shallow system-prompt pages (GreedyDual prices a page by its depth).
    prompt = list((SYSTEM_PROMPT + SYSTEM_QUESTIONS[1]).encode())
    hist = pi.match(prompt)[0]
    if hist < SYS_BLOCKS * 16:
        raise AssertionError(f"[10b] the restored pool holds {hist} tokens of the "
                             f"system prompt, want >= {SYS_BLOCKS * 16}")

    async def first_request():
        await warm.start()
        try:
            await warm.warmup()
            return await system_turn(warm, SYSTEM_QUESTIONS[1], 16)
        finally:
            await warm.stop()

    hit = asyncio.run(first_request())["hit"]
    free_engine(warm)
    del warm
    cold = cli_engine(params, cfg, "--ragged-prefill", "--spill-pages",
                      str(SPILL_PAGES), "--prefix-pool-blocks", str(SPILL_POOL_BLOCKS),
                      *flags, "--kv-quant", "int8")
    cold_blocks = cold._prefix.used_blocks
    free_engine(cold)
    del cold
    if cold_blocks:
        raise AssertionError(f"[10b] the int8 engine restored {cold_blocks} blocks")
    print(f"[10b] {SNAPSHOT_DIR}: {files} bytes; save {save_s:.3f} s at stop, load "
          f"{load_s[0]:.3f} s at construction ({name}); restored "
          f"{restored_blocks} pool blocks, pool checksum equal to the saved one; "
          f"the restored index matched {hist} tokens of a new system-prompt "
          f"conversation (system prompt {SYS_BLOCKS} pages) before any prefill; "
          f"that request then hit {hit} tokens through the tunnel; --kv-quant "
          f"int8 on the same directory started cold")


class _Fabric:
    """Prefill and decode peers behind one ``run_proxy_fabric`` with
    ``ProxyState(fabric=True)``, each peer's ``run_serve`` on its own
    loopback channel (engines started by the caller); ``async with`` yields
    the proxy's base URL."""

    def __init__(self, peers: dict):
        self.peers = peers

    async def __aenter__(self):
        from p2p_llm_tunnel_tpu_torch.endpoints.proxy import ProxyState, run_proxy_fabric
        from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
        from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
        from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

        state = ProxyState(tenant_fallback="chip-smoke", fabric=True)
        # Each handoff leg timed with its bytes: (leg, ms, bytes).
        self.legs = []
        fetch, push = state.kv_export_fetch, state.kv_splice_push

        async def timed_fetch(*a):
            t0 = time.monotonic()
            got = await fetch(*a)
            self.legs.append(("export", (time.monotonic() - t0) * 1e3,
                              len(got[1]) if got else 0))
            return got

        async def timed_push(*a):
            t0 = time.monotonic()
            got = await push(*a)
            self.legs.append(("splice", (time.monotonic() - t0) * 1e3, len(a[2])))
            return got

        state.kv_export_fetch, state.kv_splice_push = timed_fetch, timed_push
        self.chans, self.tasks = [], []
        for pid, engine in self.peers.items():
            serve_ch, proxy_ch = loopback_pair()
            self.chans.append(serve_ch)
            self.tasks.append(asyncio.create_task(run_serve(
                serve_ch, backend=engine_backend(engine, MODEL), max_inflight=64)))
            await state.admit(proxy_ch, pid)
        ready = asyncio.get_running_loop().create_future()
        self.tasks.append(asyncio.create_task(run_proxy_fabric(
            state, "127.0.0.1", 0, ready=ready)))
        return f"http://127.0.0.1:{await asyncio.wait_for(ready, 30.0)}"

    async def __aexit__(self, *exc):
        for task in self.tasks:
            task.cancel()
        for ch in self.chans:
            ch.close()
        await asyncio.gather(*self.tasks, return_exceptions=True)


def disagg_phase(params, cfg, name: str, ref: dict, add_launches) -> None:
    """[10c] Phase 5's conversations through a fabric of a ``--role
    prefill`` and a ``--role decode`` peer on one weight tree: the proxy
    has the prefill peer export each prompt's pages and splices them into
    the decode peer before the request goes out."""
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    pre = cli_engine(params, cfg, "--ragged-prefill", "--role", "prefill")
    dec = cli_engine(params, cfg, "--ragged-prefill", "--role", "decode")
    probe = SpillProbe(dec)
    export, export_batches = pre._export_copy_out, []

    def timed_export(pairs):
        t0 = time.monotonic()
        out = export(pairs)
        export_batches.append(((time.monotonic() - t0) * 1e3, len(pairs)))
        return out

    pre._export_copy_out = timed_export
    counters = ("proxy_disagg_fallbacks_total", "proxy_disagg_handoffs_total",
                "engine_page_xfer_bytes_total", "engine_page_refusals_total",
                "engine_pages_shipped_total", "engine_pages_spliced_total")
    before = {c: global_metrics.counter(c) for c in counters}
    fabric = _Fabric({"prefill-0": pre, "decode-0": dec})
    t0 = time.monotonic()

    async def drive():
        for e in (pre, dec):
            await e.start()
        try:
            for e in (pre, dec):
                await e.warmup()
            t_ready = time.monotonic() - t0
            return t_ready, await mux_phase(dec, peers=(pre,), tunnel=fabric,
                                            hit_gate=False)
        finally:
            for e in (pre, dec):
                await e.stop()

    try:
        t_ready, m = asyncio.run(drive())
    finally:
        probe.restore()
        pre._export_copy_out = export
    d = {c: global_metrics.counter(c) - v for c, v in before.items()}
    shipped, spliced = pre.disagg_stats()["pages_shipped"], dec._prefix.wire_spliced
    print_mux("[10c]", dec, m, t_ready, name)
    print(f"[10c] handoffs {d['proxy_disagg_handoffs_total']:.0f}, fallbacks "
          f"{d['proxy_disagg_fallbacks_total']:.0f}, refusals "
          f"{d['engine_page_refusals_total']:.0f}; pages shipped {shipped} = "
          f"offered to the decode peer {probe.offered} = spliced {spliced} + already "
          f"resident there {probe.resident}; transfer bytes "
          f"{d['engine_page_xfer_bytes_total']:.0f}")
    print(f"[10c] export {SpillProbe.per_page(export_batches):.3f} ms a page on the "
          f"prefill peer, splice {SpillProbe.per_page(probe.in_batches):.3f} ms a page "
          f"on the decode peer, import call {statistics.median(probe.import_ms):.1f} "
          f"ms median over {len(probe.import_ms)} transfers ({name})")
    for leg in ("export", "splice"):
        rows = [(ms, n) for kind, ms, n in fabric.legs if kind == leg]
        mb = sum(n for _, n in rows) / 1e6
        secs = sum(ms for ms, _ in rows) / 1e3
        print(f"[10c] proxy {leg} leg: {len(rows)} transfers, median "
              f"{statistics.median(ms for ms, _ in rows):.1f} ms, {mb:.1f} MB in "
              f"{secs:.2f} s of leg time = {mb / secs:.1f} MB/s (the prefill probe "
              f"and the engines' copies included; legs overlap) ({name})")
    print(f"[10c] TTFT p50 {m['ttft_p50_ms']:.1f} ms (turn 1 "
          f"{m['turn1_ttft_p50_ms']:.1f}, turn 2 {m['turn2_ttft_p50_ms']:.1f}) against "
          f"phase 5's {ref['ttft_p50_ms']:.1f} ms (turn 1 {ref['turn1_ttft_p50_ms']:.1f}, "
          f"turn 2 {ref['turn2_ttft_p50_ms']:.1f}) ({name}); tokens before the first "
          f"divergence from phase 5 {divergence(m['one'] + m['two'], ref['one'] + ref['two'])}")
    stats = (pre.disagg_stats(), dec.disagg_stats())
    if shipped <= 0 or spliced <= 0 or not (
            shipped == probe.offered == spliced + probe.resident
            == d["engine_pages_shipped_total"]):
        raise AssertionError(f"[10c] shipped {shipped}, offered {probe.offered}, "
                             f"spliced {spliced}, resident {probe.resident}, {d}")
    if d["proxy_disagg_fallbacks_total"] or d["engine_page_refusals_total"]:
        raise AssertionError(f"[10c] fallbacks or refusals: {d}")
    if any(s["xfer_inflight"] for s in stats):
        raise AssertionError(f"[10c] transfers in flight after the drain: {stats}")
    if probe.mismatched or probe.checked != spliced:
        raise AssertionError(f"[10c] {probe.checked} re-exports of {spliced} spliced "
                             f"pages; checksum mismatches {probe.mismatched}")
    add_launches(m["launches"])
    for e in (pre, dec):
        free_engine(e)


def spill_phases(params, cfg, name: str, ref: dict, ref_int4: dict,
                 add_launches) -> None:
    """Phase 10 on phase 5's weights: 10a, 10b, 10c; ``ref`` and
    ``ref_int4`` are phases 5's and 6a's runs (the tier off)."""
    import shutil

    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    try:
        snap = ("--prefix-cache-dir", SNAPSHOT_DIR)
        t0 = time.monotonic()
        engine, _m, save_s = spill_run("[10a]", params, cfg, snap, name, ref,
                                       add_launches, snapshot=True)
        free_engine(engine)
        del engine
        e4, _m4, _ = spill_run("[10a int4]", params, cfg,
                               ("--kv-quant", "int4", "--fused-decode-layer"),
                               name, ref_int4, add_launches)
        from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import pool_packed_keys

        if (pool_packed_keys(e4.kv_cache) != frozenset({"k", "v"})
                or e4._pool["k"].shape[2] * 2 != e4._prefix_block):
            raise AssertionError("[10a int4] pool pages are not packed half pages")
        free_engine(e4)
        del e4
        print(f"[10a] phase {time.monotonic() - t0:.1f} s ({name})")
        t0 = time.monotonic()
        snapshot_phase(params, cfg, snap, save_s[0], name)
        print(f"[10b] phase {time.monotonic() - t0:.1f} s ({name})")
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    t0 = time.monotonic()
    disagg_phase(params, cfg, name, ref, add_launches)
    print(f"[10c] phase {time.monotonic() - t0:.1f} s ({name})")


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: tensor-parallel serving, SPMD ranks and the replica router
# ---------------------------------------------------------------------------

TP = 2
#: Collective and control-plane timeout of phase 11's run: a rank that
#: hears nothing from its peer for this long raises instead of hanging.
TP_TIMEOUT_S = 300.0
#: 11c's int4 group size (the serve default; a row-parallel shard holds
#: whole groups: llama3-8b's wo K/2 2048 = 16 of them).
TP_GROUP = 128
#: llama3-8b's products at tp 2, each rank's shard: the row-parallel wo and
#: w_down contract K/2, the column-parallel ones and the head output N/2
#: (the head's 64128 columns are no multiple of a 256-column tile).
TP2_QUANT_SHAPES = (("tp2 wq", 2048, 4096), ("tp2 wk/wv", 512, 4096),
                    ("tp2 wo", 4096, 2048), ("tp2 w_gate/w_up", 7168, 4096),
                    ("tp2 w_down", 4096, 7168), ("tp2 lm_head", 64128, 4096))


def tp_logits(cfg, params, mesh, prompt, forced):
    """One prompt's prefill and teacher-forced decode steps through the
    kernel path, on a tp mesh's shard (or on the whole tree with no mesh);
    the stacked last-position logits ``[1 + len(forced), V]``."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    dev = params["final_norm"].device
    kh = cfg.n_kv_heads // (mesh.tp if mesh is not None else 1)
    cache = tr.init_kv_cache(dataclasses.replace(cfg, n_kv_heads=kh), 1, 512,
                             torch.bfloat16, device=dev)
    toks = torch.as_tensor(prompt, device=dev)[None]
    with torch.inference_mode():
        last, _ = tr.prefill_into_cache(
            cfg, params, toks, torch.tensor([len(prompt)], device=dev), cache,
            torch.tensor([0], device=dev), mesh=mesh)
        out = [last[0]]
        for n, tok in enumerate(forced):
            pos = torch.tensor([len(prompt) + n], dtype=torch.int32, device=dev)
            logits, _ = tr.decode_step(cfg, params, cache,
                                       torch.tensor([int(tok)], device=dev), pos,
                                       kv_view=256, mesh=mesh)
            out.append(logits[0])
    return torch.stack(out)


def follow_engine(params, cfg, flags, fences=(), model=None, layers=None,
                  dp_run=None) -> dict:
    """A follower rank's half of one phase-11, 12 or 13 engine: the engine
    rank 0 builds from the same flags (on the same full tree, sharded by
    the engine, or on its own draw of this rank's shard), its replay of
    rank 0's dispatches until rank 0 stops, and this rank's own launch
    checks — kernel 1 once per layer per prefill wave it runs (none under
    ring sp), the decode kernel once per layer per decode step, kernel 5
    once per layer per verify burst on the fused layer, kernel 6 once per
    layer per ragged dispatch it runs, kernel 7 225 times per model call
    under ``--quant`` (on the card); with its peak memory, the exchanges it
    ran and (sp, dp) its cache rows against one rank's.  ``model`` and
    ``layers`` serve another preset, cut to a depth; ``dp_run`` = (the
    run's coordinator, world) builds the engine through the serve CLI's
    ``--coordinator`` flags (``dp_engine``)."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    if model is not None:
        cfg = get_config(model)
    model = model or MODEL
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dp_run is not None:
        engine = dp_engine(cfg, flags, *dp_run)
    else:
        engine = cli_engine(params, cfg, *flags, model=model, fences=fences,
                            depth_cut=bool(layers))
    mesh = engine.mesh
    recorded = record_waves(engine) if mesh.sp > 1 or mesh.dp > 1 else None
    steps, waves, dispatches, spec = [0], [0], [0], [0]
    fns = {n: getattr(engine, n) for n in ("_decode_fn", "_prefill_rows",
                                           "_ragged_rows", "_spec_verify_fn")}

    def counted(name, tally, n=lambda a: 1):
        def call(*a):
            tally[0] += n(a)
            return fns[name](*a)
        return call

    engine._decode_fn = counted("_decode_fn", steps, lambda a: a[5])
    engine._prefill_rows = counted("_prefill_rows", waves)
    engine._ragged_rows = counted("_ragged_rows", dispatches)
    engine._spec_verify_fn = counted("_spec_verify_fn", spec)
    engine._launch_probe_fn = uncounted(engine._launch_probe_fn)
    reset_counters()
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops = engine.spmd_follower_loop()
    launches, calls = read_counters(), dict(MODEL_CALLS)
    per_wave = k1_per_wave(engine.mcfg, mesh)
    if engine.device.type == "cuda":
        if launches["flash_causal_attention"] != per_wave * waves[0]:
            raise AssertionError(f"rank {mesh.rank}: kernel 1 launches "
                                 f"{launches['flash_causal_attention']} != "
                                 f"{per_wave} x {waves[0]} prefill waves")
        check_engine_launches(engine, launches, steps[0], dispatches[0], spec[0],
                              calls)
    peak, forms = peak_gb(engine.device), exchange_counts()
    cache = None if recorded is None else check_sp_cache(engine, recorded)
    out = dict(rank=mesh.rank, ops=ops, steps=steps[0], waves=waves[0],
               dispatches=dispatches[0], spec=spec[0], calls=calls,
               launches={k: v for k, v in launches.items() if v},
               peak_gb=peak, exchanges=forms, cache=cache,
               kv_rows=int(engine.kv_cache["k"].shape[1]),
               kv_bytes=kv_bytes(engine), weights_gb=weight_gb(engine))
    free_engine(engine)
    return out


def record_waves(engine) -> list:
    """Keep a host copy of every whole-prompt wave's (tokens, lengths,
    slots) the engine prefills from now on; returns the list it fills."""
    import numpy as np

    waves, prefill_fn = [], engine._prefill_fn

    def recorded(tokens, lengths, slots, *a, **kw):
        waves.append(tuple(np.array(x, copy=True) for x in (tokens, lengths, slots)))
        return prefill_fn(tokens, lengths, slots, *a, **kw)

    engine._prefill_fn = recorded
    return waves


#: Phase 12's bounds on an sp engine's cache rows against one rank's: per
#: layer, raw K/V within 5% of the layer's max |K| / |V| (11b's bound on
#: logits), quantized codes with at least 90% of their bytes equal and
#: scales within 5% of the layer's max scale (a misplaced block or row
#: changes most bytes; rounding noise flips a few codes).
SP_CACHE_REL, SP_CACHE_EQUAL = 0.05, 0.9


def check_sp_cache(engine, waves) -> str:
    """The sp or dp engine's cache rows against one rank's: each prompt row
    of the recorded ``waves`` whose slot no later wave rewrote and this
    rank holds (warmup's pad rows go to the scratch slot; under dp a rank
    holds its own slots' rows) is compared with the same wave prefilled
    whole by this rank alone (``prefill_into_cache``, no mesh) into a
    fresh cache of the engine's layout, over the prompt's positions,
    within ``SP_CACHE_REL`` / ``SP_CACHE_EQUAL``; under dp the quantized
    codes and scales must be bitwise those rows, and the last logits of
    this rank's rows prefilled as the rank runs them (its rows alone)
    within 11b's bound of that whole wave's.  Raises past them; returns
    the worst figures."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    cache = engine.kv_cache
    mode = tr.kv_cache_quant_mode(cache)
    dev = cache["k"].device
    dp = engine._dp
    lo = 0 if dp is None else dp.lo
    seen, rows, rel, equal, bitwise = set(), 0, 0.0, 1.0, True
    logit_diff, logit_scale, agree = 0.0, 0.0, []

    def layer_max(x):
        return x.float().abs().flatten(1).amax(1)

    for tokens, lengths, slots in reversed(waves):
        mine = range(len(slots)) if dp is None else dp.route(slots)
        check = [(i, int(slots[i])) for i in mine
                 if slots[i] != engine._scratch_slot and slots[i] not in seen]
        seen.update(s for _, s in check)
        if not check:
            continue
        fresh = tr.init_kv_cache(engine.mcfg, len(slots), tr._seq_len(cache),
                                 cache["k"].dtype, quant=mode or False, device=dev)
        toks, lens = (torch.as_tensor(x, device=dev) for x in (tokens, lengths))
        with torch.inference_mode():
            last, _ = tr.prefill_into_cache(engine._prefill_mcfg, engine.params,
                                            toks, lens, fresh,
                                            torch.arange(len(slots), device=dev))
            if dp is not None:
                own = torch.as_tensor([i for i, _ in check], device=dev)
                sub = tr.init_kv_cache(engine.mcfg, len(own), tr._seq_len(cache),
                                       cache["k"].dtype, quant=mode or False,
                                       device=dev)
                mine_last, _ = tr.prefill_into_cache(
                    engine._prefill_mcfg, engine.params, toks[own], lens[own], sub,
                    torch.arange(len(own), device=dev))
                del sub
                logit_diff = max(logit_diff,
                                 (mine_last - last[own]).abs().max().item())
                logit_scale = max(logit_scale, last[own].abs().max().item())
                agree += (mine_last.argmax(-1) == last[own].argmax(-1)).tolist()
        for i, s in check:
            n = int(lengths[i])
            rows += 1
            for name in ("k", "v"):
                nb = n // 2 if mode == "int4" else n
                got, ref = cache[name][:, s - lo, :nb], fresh[name][:, i, :nb]
                bitwise &= torch.equal(got, ref)
                if mode is None:
                    rel = max(rel, (layer_max(got.float() - ref.float())
                                    / layer_max(ref).clamp(min=1e-30)).max().item())
                    continue
                equal = min(equal, (got == ref).flatten(1).float().mean(1).min().item())
                gs, rs = (cache[name + "_scale"][:, s - lo, :n],
                          fresh[name + "_scale"][:, i, :n])
                bitwise &= torch.equal(gs, rs)
                rel = max(rel, (layer_max(gs - rs) / layer_max(rs).clamp(min=1e-30))
                          .max().item())
        del fresh
    if not rows:
        raise AssertionError("no served prompt row to check in the engine's cache")
    what = ("K/V, max |diff| / the layer's max" if mode is None else
            f"{mode} codes: least share of equal bytes in a layer {equal:.4f} "
            f"(limit {SP_CACHE_EQUAL}); scales, max |diff| / the layer's max")
    out = (f"cache rows of {rows} prompts vs one rank's prefill_into_cache: {what} "
           f"{rel:.4g} (limit {SP_CACHE_REL}); bitwise equal {bitwise}")
    bad_logits = False
    if dp is not None:
        share = sum(agree) / len(agree)
        out += (f"; last logits of its rows alone vs the whole wave's: max |diff| "
                f"{logit_diff:.4g} (limit {0.05 * logit_scale:.4g} = 5% of max |logit|), "
                f"argmax agreement {share:.2f}")
        bad_logits = logit_diff > 0.05 * logit_scale or share < 0.8
    if (rel > SP_CACHE_REL or equal < SP_CACHE_EQUAL or bad_logits
            or (dp is not None and mode is not None and not bitwise)):
        raise AssertionError(f"rank {engine.mesh.rank}: {out}")
    return out


def peak_gb(device) -> float:
    """This process's peak device memory since the last reset, in GB."""
    import torch

    return (torch.cuda.max_memory_allocated(device) / 1e9
            if torch.device(device).type == "cuda" else 0.0)


def exchange_counts() -> dict:
    """The sp exchanges this process ran since the last reset, by
    exchange."""
    from p2p_llm_tunnel_tpu_torch.parallel import collectives

    return dict(sorted(collectives.exchanges.items()))


def mesh_follower(coordinator: str, rank: int, results, settings: dict) -> None:
    """A follower rank of phase 11, 12 or 13, a spawned process: takes rank
    0's module settings (``DEVICE``, ``MODEL``, ``NUM_SLOTS``, ``MAX_SEQ``,
    ``TP_GROUP`` and the run's ``MESH`` = (tp, sp, ep, dp)), joins the run,
    then obeys rank 0's commands on a control group of its own —
    ``weights`` (draw, at an optional depth, or drop the full seed-0 tree
    rank 0 draws), ``shard`` (draw this rank's shard of a preset's seed-0
    tree at a depth, or drop it), ``logits`` (the tp forward of 11b),
    ``sp_logits`` (a prefill of 12a / 12d / 12e, its report to
    ``results``), ``ep_logits`` (13a / 13c / 13e's prefill on the shard),
    ``sp_bench`` (12e's exchanges) and ``ep_bench`` (13e's all-reduces),
    ``engine`` (``follow_engine``; its report to ``results``) and
    ``exit``.  A failure is reported to rank 0, which fails the phase."""
    import dataclasses
    import gc
    import traceback

    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import init_params
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh, shard_params
    from p2p_llm_tunnel_tpu_torch.parallel.spmd_serve import SpmdCoordinator

    globals().update(settings)
    tp, sp, ep, dp = MESH
    try:
        dev = pd.rank_device(DEVICE, rank)
        pd.init_distributed(coordinator, tp * sp * ep * dp, rank, device=dev,
                            timeout_s=TP_TIMEOUT_S)
        torch.backends.cuda.matmul.allow_tf32 = False
        count_model_calls()
        mesh = make_mesh(tp=tp, sp=sp, ep=ep, dp=dp)
        ctl = SpmdCoordinator(mesh)
        cfg = get_config(MODEL)
        full = shard = shard_cfg = None
        while True:
            op, args = ctl.recv()
            if op == "exit":
                break
            if op == "weights":
                draw, layers = args
                if layers:
                    cfg = dataclasses.replace(get_config(MODEL), n_layers=layers)
                full = init_params(cfg, 0, torch.bfloat16, dev) if draw else None
                gc.collect()
                torch.cuda.empty_cache()
            elif op == "shard":
                shard = None
                gc.collect()
                torch.cuda.empty_cache()
                if args:
                    shard_cfg = dataclasses.replace(get_config(args[0]),
                                                    n_layers=args[1])
                    shard = init_params(shard_cfg, 0, torch.bfloat16, dev, mesh=mesh)
            elif op == "ep_logits":
                results.put(("ep_logits", follow_ep_prefill(shard, shard_cfg, mesh,
                                                            *args)))
            elif op == "ep_bench":
                results.put(("ep_bench", ep_allreduce_bench(mesh, *args)))
            elif op == "logits":
                tp_shard = shard_params(full, cfg, mesh)
                tp_logits(cfg, tp_shard, mesh, *args)
                del tp_shard
            elif op == "sp_logits":
                results.put(("sp_logits", follow_sp_prefill(full, cfg, mesh, *args)))
            elif op == "sp_bench":
                results.put(("sp_bench", exchange_bench(cfg, mesh, *args)))
            elif op == "engine":
                results.put(("engine", follow_engine(full, cfg, *args)))
            elif op == "dp_engine":
                results.put(("engine", follow_engine(
                    None, cfg, *args, dp_run=(coordinator, tp * sp * ep * dp))))
        results.put(("exit", rank))
    except BaseException:  # reported to rank 0, which fails the phase
        results.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
    finally:
        pd.shutdown_distributed()


def follower_report(results, want: str):
    """A follower's next report (``want``), or its failure, within the
    run's timeout."""
    import queue

    try:
        kind, value = results.get(timeout=TP_TIMEOUT_S)
    except queue.Empty:
        raise AssertionError(f"no follower sent a {want} report within "
                             f"{TP_TIMEOUT_S:.0f} s") from None
    if kind == "error":
        raise AssertionError(f"a follower failed: {value}")
    if kind != want:
        raise AssertionError(f"a follower reported {kind}, not {want}")
    return value


class MeshRun:
    """Rank 0 of a run of ``tp x sp x ep x dp`` ranks on this host (phases
    11-13): the other ranks are spawned processes running
    ``mesh_follower``, joined by the backend rule (gloo where they share
    the card), driven on a control group of their own.  ``close`` makes
    them exit and joins them (killing what is left)."""

    def __init__(self, tp: int, sp: int, ep: int = 1, dp: int = 1):
        import multiprocessing

        from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd
        from p2p_llm_tunnel_tpu_torch.parallel import make_mesh
        from p2p_llm_tunnel_tpu_torch.parallel.spmd_serve import SpmdCoordinator

        self.world = tp * sp * ep * dp
        coordinator = self.coordinator = pd.local_rendezvous()
        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        settings = dict(DEVICE=DEVICE, MODEL=MODEL, NUM_SLOTS=NUM_SLOTS,
                        MAX_SEQ=MAX_SEQ, TP_GROUP=TP_GROUP, MESH=(tp, sp, ep, dp))
        self.procs = [ctx.Process(target=mesh_follower,
                                  args=(coordinator, r, self.results, settings),
                                  name=f"mesh-rank-{r}", daemon=True)
                      for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        self.closed = False
        try:
            dev = pd.rank_device(DEVICE, 0)
            self.backend = pd.init_distributed(coordinator, self.world, 0, device=dev,
                                               timeout_s=TP_TIMEOUT_S)
            self.mesh = make_mesh(tp=tp, sp=sp, ep=ep, dp=dp)
            self.ctl = SpmdCoordinator(self.mesh)
        except BaseException:
            self.close(clean=False)
            raise

    def reports(self, want: str) -> list:
        """One ``want`` report from every follower, by rank."""
        got = [follower_report(self.results, want) for _ in self.procs]
        return sorted(got, key=lambda r: r["rank"] if isinstance(r, dict) else r)

    def close(self, clean: bool = True) -> None:
        from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

        if self.closed:
            return
        self.closed = True
        try:
            if clean:
                self.ctl.send("exit", ())
                self.reports("exit")
                # Leave the world with the followers, then join them:
                # NCCL's teardown waits for every rank.
                pd.shutdown_distributed()
        finally:
            for p in self.procs:
                p.join(60.0)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
            pd.shutdown_distributed()
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if clean and bad:
            raise AssertionError(f"follower ranks exited {bad}")


def tp_engine_run(run: MeshRun, params, cfg, flags, phase, tag, name) -> dict:
    """One tp 2 engine: rank 1 is told to build it from the same flags,
    rank 0 builds it, serves ``phase`` through the tunnel and stops it;
    both ranks' launch checks hold and rank 1 replayed every step."""
    run.ctl.send("engine", (flags,))
    engine = cli_engine(params, cfg, *flags, model=MODEL)
    t_ready, out = run_engine(engine, phase)
    peer, = run.reports("engine")
    if out["steps"] > peer["steps"] or out["waves"] > peer["waves"]:
        raise AssertionError(f"{tag} rank 1 replayed {peer['steps']} decode steps "
                             f"and {peer['waves']} waves; rank 0 served "
                             f"{out['steps']} and {out['waves']}")
    kh = engine.kv_cache["k"].shape[3]
    print(f"{tag} {' '.join(flags)}: ready in {t_ready:.1f} s; rank 0 serves "
          f"(mesh {engine.mesh.shape}, {kh} of {cfg.n_kv_heads} kv heads and "
          f"{cfg.n_heads // TP} of {cfg.n_heads} query heads a rank); rank 1 "
          f"replayed {peer['ops']} ops")
    print(f"{tag} rank 0 in the served window: {out['waves']} prefill waves, "
          f"{out['steps']} decode steps, launch counts "
          f"{ {k: v for k, v in out['launches'].items() if v} }")
    print(f"{tag} rank 1 (warmup included): {peer['waves']} prefill waves, "
          f"{peer['steps']} decode steps, model calls {peer['calls']}, launch "
          f"counts {peer['launches']} (kernel 1 {cfg.n_layers} a wave, the "
          f"decode kernel {cfg.n_layers} a step: checked on each rank)")
    print(f"{tag} {out['tok_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms "
          f"({name}; client side through the tunnel; both ranks on one card: "
          f"no interconnect measured)")
    if engine.ecfg.quant not in ("none", ""):
        print_quant_launches(tag, out, engine)
    free_engine(engine)
    return out


def tp_phase(name: str, add_launches) -> None:
    """Phase 11: ``--tp 2`` at llama3-8b's full width, ranks 0 and 1 (rank 1
    a spawned process, as ``tunnel-gpu serve --tp 2`` starts it) on one
    card: (b) tp 2 logits against a tp 1 forward on the same weights;
    (a) the serve-CLI defaults on phase 5's conversations, and the plain
    loop (kernel 1); (c) ``--quant int4 --kv-quant int8``."""
    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import init_params
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd
    from p2p_llm_tunnel_tpu_torch.parallel import shard_params

    cfg = get_config(MODEL)
    run = MeshRun(TP, 1)
    try:
        devices = [str(pd.rank_device(DEVICE, r)) for r in range(TP)]
        print(f"[11] --tp {TP}: rank 0 here, rank 1 a spawned process, on "
              f"{devices} of {torch.cuda.device_count()} card(s): backend "
              f"{run.backend} ({'NCCL: a card a rank' if run.backend == 'nccl' else 'gloo: ranks share a card, NCCL refuses two ranks on one GPU'}); "
              f"control plane gloo; tp on one card measures no interconnect")
        full = init_params(cfg, 0, torch.bfloat16, DEVICE)
        run.ctl.send("weights", (True, None))
        # 11b: tp 2 against tp 1, the same weights and tokens.
        rng = np.random.default_rng(7)
        prompt = rng.integers(0, 256, 200).astype(np.int64)
        forced = rng.integers(0, 256, 4).astype(np.int64)
        ref = tp_logits(cfg, full, None, prompt, forced)
        run.ctl.send("logits", (prompt, forced))
        shard = shard_params(full, cfg, run.mesh)
        got = tp_logits(cfg, shard, run.mesh, prompt, forced)
        del shard
        diff = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        if not torch.isfinite(got).all() or diff > 0.05 * scale or agree < 0.8:
            raise AssertionError(f"[11b] tp 2 logits drift {diff:.4g} (limit "
                                 f"{0.05 * scale:.4g}), argmax agreement {agree:.2f}")
        print(f"[11b] tp {TP} vs tp 1 on the same weights (prefill of "
              f"{len(prompt)} tokens + {len(forced)} teacher-forced decode steps, "
              f"kernels 1 and 2 on both): max |diff| {diff:.4g} (limit "
              f"{0.05 * scale:.4g} = 5% of max |logit| {scale:.4g}), argmax "
              f"agreement {agree:.2f}")
        # 11a: the serve defaults (mux, prefix pool, conversation cache;
        # chunked prefill, kernel 2 per head shard), then the plain loop.
        m = tp_engine_run(run, full, cfg, ("--tp", str(TP)), mux_phase, "[11a]", name)
        add_launches(m["launches"])
        m = tp_engine_run(run, full, cfg, ("--tp", str(TP), "--no-mux"),
                          lambda e: serve_phase(e, 4, 16), "[11a plain]", name)
        add_launches(m["launches"])
        run.ctl.send("weights", (False, None))
        del full
        torch.cuda.empty_cache()
        # 11c: weights drawn directly in packed int4 from seed 0 (by each
        # rank's engine), sharded; kernel 7 at the shard shapes.
        m = tp_engine_run(run, None, cfg,
                          ("--tp", str(TP), "--quant", "int4", "--quant-group-size",
                           str(TP_GROUP), "--kv-quant", "int8"),
                          mux_phase, "[11c]", name)
        add_launches(m["launches"])
        run.close()
    finally:
        run.close(clean=False)


def replica_phase(name: str, add_launches) -> None:
    """Phase 11d: ``--replicas 2`` — two engines (seed 0 and seed 1, each on
    ``cuda:(i % device_count)``) on the serve-CLI defaults behind one
    router and one tunnel; both replicas take streams, and the decode
    kernel launches once per layer per decode step summed over both."""
    import torch

    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.router import ReplicaRouter, router_backend
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.distributed import rank_device

    cfg = get_config(MODEL)
    args = cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", MODEL,
        "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ), "--replicas", "2"])
    t0 = time.monotonic()
    engines = [InferenceEngine(engine_cfg=cli._engine_config(args, seed=i),
                               tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size),
                               device=rank_device(DEVICE, i))
               for i in range(args.replicas)]
    router = ReplicaRouter(engines, MODEL)
    steps, streams = [0] * len(engines), [0] * len(engines)
    for i, e in enumerate(engines):
        decode_fn, generate = e._decode_fn, e.generate

        def counted_decode(*a, _i=i, _fn=decode_fn):
            steps[_i] += a[5]
            return _fn(*a)

        def counted_generate(*a, _i=i, _fn=generate, **kw):
            streams[_i] += 1
            return _fn(*a, **kw)

        e._decode_fn, e.generate = counted_decode, counted_generate
    prompts = [(f"Replica request {i}: summarise the tunnel design. " * 4)[: 120 + 30 * i]
               for i in range(N_REQUESTS)]

    async def drive():
        await router.start()
        try:
            for e in engines:
                await e.warmup()
            t_ready = time.monotonic() - t0
            async with _Tunnel(None, router_backend(router)) as base:
                reset_counters()
                steps[:] = [0] * len(engines)
                t1 = time.monotonic()
                out = await asyncio.gather(*[_stream(base, i, 32, p)
                                             for i, p in enumerate(prompts)])
                return t_ready, out, time.monotonic() - t1, read_counters()
        finally:
            await router.stop()

    t_ready, out, wall, launches = asyncio.run(drive())
    for r in out:
        if r["tokens"] != 32 or r["finish"] != "length":
            raise AssertionError(f"[11d] stream ended early: {r}")
    if min(streams) == 0:
        raise AssertionError(f"[11d] a replica took no stream: {streams}")
    check_engine_launches(engines[0], launches, sum(steps), 0)
    print(f"[11d] --replicas 2: replica i seed i on "
          f"{[str(e.device) for e in engines]} (seeds "
          f"{[e.ecfg.seed for e in engines]}), ready in {t_ready:.1f} s; "
          f"{len(out)} streams x 32 tokens, streams per replica {streams}, decode "
          f"steps per replica {steps}; {sum(r['tokens'] for r in out) / wall:.1f} "
          f"tok/s ({name}; client side through the tunnel, both replicas on "
          f"one card)")
    add_launches(launches)
    for e in engines:
        free_engine(e)
    del engines, router
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: sequence parallelism (--sp 2, ring and Ulysses)
# ---------------------------------------------------------------------------

SP = 2
#: Long context is what sp is for: 12a prefills one prompt of SP_T
#: tokens; 12b/12c serve prompts of SP_PROMPT_LENS bytes (= tokens) with
#: 4096 positions a slot, in waves of SP_PREFILL_ROWS rows (a ring step's
#: f32 scores are [B, K, G, T/sp, T/sp]: 1.07 GB at B 2, T 4096 — each
#: rank also holds the whole bf16 tree, ~16 GB, on the one card).
SP_T = 4096
SP_PROMPT_LENS = (1500, 2300, 3100, 3800)
SP_MAX_TOKENS = 32
SP_PREFILL_ROWS = 2
SP_FLAGS = ("--sp", str(SP), "--max-seq", "4096", "--slots", "4",
            "--prefill-rows", str(SP_PREFILL_ROWS))
#: What the serve defaults fence under sp (the reference's fences).
SP_FENCES = ("prefix_cache", "conv_cache")
#: 12d: four ranks on the one card each hold a tree of llama3-8b's full
#: width cut to this depth (4 x 5.6 GB at bf16; 32 layers would be 4 x 16 GB).
SP_TP_LAYERS = 8


def sp_prefill(cfg, params, mesh, tokens, timed: bool = True) -> dict:
    """One prompt's ``prefill`` through the kernel path under ``mesh``
    (None: this rank alone): the logits at every 64th position and the
    last (f32) and the K/V of the first and last layers there (this rank's
    tp heads), with kernel 1's launches, the exchanges run, the peak
    memory, and the prefill's wall ms.  ``timed``: also the part of it
    spent in the exchanges' all-reduces (host clock, the card synchronized
    around each)."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.parallel import collectives

    dev = params["final_norm"].device
    reset_counters()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    toks = torch.as_tensor(tokens, device=dev)[None]
    pick = torch.tensor(list(range(0, len(tokens), 64)) + [len(tokens) - 1],
                        device=dev)
    spent, slot_sum = [0.0], collectives._slot_sum

    def timed_sum(buf, group):
        sync(dev)
        t = time.monotonic()
        out = slot_sum(buf, group)
        sync(dev)
        spent[0] += time.monotonic() - t
        return out

    if timed:
        collectives._slot_sum = timed_sum
    try:
        sync(dev)
        t0 = time.monotonic()
        with torch.inference_mode():
            logits, ks, vs = tr.prefill(cfg, params, toks,
                                        torch.ones_like(toks, dtype=torch.bool),
                                        mesh=mesh)
            out = dict(logits=logits[0, pick], k=ks[[0, -1], 0][:, pick],
                       v=vs[[0, -1], 0][:, pick])
        sync(dev)
        out.update(wall_ms=(time.monotonic() - t0) * 1e3, exchange_ms=spent[0] * 1e3)
    finally:
        collectives._slot_sum = slot_sum
    del logits, ks, vs
    want = k1_per_wave(cfg, mesh)
    got = read_counters()["flash_causal_attention"]
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"rank {0 if mesh is None else mesh.rank}: kernel 1 "
                             f"launches {got} != {want} in one {cfg.sp_mode} prefill")
    out.update(k1=got, exchanges=exchange_counts(), peak_gb=peak_gb(dev))
    return out


def follow_sp_prefill(full, cfg, mesh, mode: str, tokens, timed=True) -> dict:
    """A follower's half of 12a / 12d / 12e: the same prefill on this
    rank's tp shard of the tree, in ``mode``; its report (launch check
    included)."""
    import dataclasses

    from p2p_llm_tunnel_tpu_torch.parallel import shard_params

    params = shard_params(full, cfg, mesh) if mesh.tp > 1 else full
    out = sp_prefill(dataclasses.replace(cfg, sp_mode=mode), params, mesh, tokens,
                     timed)
    report = {k: out[k] for k in ("k1", "exchanges", "peak_gb", "wall_ms", "exchange_ms")}
    report["rank"] = mesh.rank
    return report


def compare_logits(tag: str, got: dict, ref: dict, heads=None) -> str:
    """11b's bound on bf16 logits: max |diff| within 5% of max |logit| and
    argmax agreement >= 0.8; the K/V difference printed (``heads``: the
    reference's heads this rank holds)."""
    import torch

    diff = (got["logits"] - ref["logits"]).abs().max().item()
    scale = ref["logits"].abs().max().item()
    agree = (got["logits"].argmax(-1) == ref["logits"].argmax(-1)).float().mean().item()
    if not torch.isfinite(got["logits"]).all() or diff > 0.05 * scale or agree < 0.8:
        raise AssertionError(f"{tag} logits drift {diff:.4g} (limit {0.05 * scale:.4g}), "
                             f"argmax agreement {agree:.2f}")
    sl = slice(None) if heads is None else heads
    kv = max((got[n].float() - ref[n][..., sl, :].float()).abs().max().item()
             for n in ("k", "v"))
    return (f"max |diff| {diff:.4g} (limit {0.05 * scale:.4g} = 5% of max |logit| "
            f"{scale:.4g}) over {ref['logits'].shape[0]} positions, argmax agreement "
            f"{agree:.2f}; K/V of the first and last layers there, max |diff| {kv:.4g}")


def sp_engine_run(run: MeshRun, params, cfg, flags, tag: str, name: str) -> dict:
    """One sp engine: every follower builds it from the same flags, rank 0
    builds it and serves the long prompts through the tunnel; each rank's
    launch checks hold and each replayed every wave and step."""
    flags = SP_FLAGS + tuple(flags)
    run.ctl.send("engine", (flags, SP_FENCES))
    engine = cli_engine(params, cfg, *flags, model=MODEL, fences=SP_FENCES)
    waves = record_waves(engine)
    prompts = [(f"Long request {i}: summarise the tunnel design, every layer. " * 80)[:n]
               for i, n in enumerate(SP_PROMPT_LENS)]
    if engine.device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(engine.device)
    t_ready, out = run_engine(engine, lambda e: serve_phase(
        e, len(prompts), SP_MAX_TOKENS, prompts=prompts))
    peak, forms = peak_gb(engine.device), exchange_counts()
    cache = check_sp_cache(engine, waves)
    peers = run.reports("engine")
    for peer in peers:
        if out["steps"] > peer["steps"] or out["waves"] > peer["waves"]:
            raise AssertionError(f"{tag} rank {peer['rank']} replayed {peer['steps']} "
                                 f"decode steps and {peer['waves']} waves; rank 0 "
                                 f"served {out['steps']} and {out['waves']}")
    ec = engine.ecfg
    print(f"{tag} {' '.join(flags)}: ready in {t_ready:.1f} s; fences "
          f"{[f['knob'] for f in engine.config_fences]} (mux {ec.mux}, whole-prompt "
          f"waves: prefill_chunk {ec.prefill_chunk}); sp_mode {engine.mcfg.sp_mode}, "
          f"kv_quant {ec.kv_quant}, fused decode layer {engine.mcfg.fused_decode_layer}; "
          f"{len(prompts)} prompts of {list(SP_PROMPT_LENS)} bytes x {SP_MAX_TOKENS} tokens")
    print(f"{tag} rank 0: {out['waves']} prefill waves, {out['steps']} decode steps, "
          f"launch counts { {k: v for k, v in out['launches'].items() if v} } (kernel 1 "
          f"{k1_per_wave(engine.mcfg, engine.mesh)} a wave, the decode kernel {engine.mcfg.n_layers} a "
          f"step), peak memory {peak:.3f} GB, exchanges in the served window {forms}")
    print(f"{tag} rank 0 {cache}")
    for peer in peers:
        print(f"{tag} rank {peer['rank']} (warmup included): {peer['waves']} waves, "
              f"{peer['steps']} decode steps, replayed {peer['ops']} ops, launch counts "
              f"{peer['launches']}, peak memory {peer['peak_gb']:.3f} GB, exchanges "
              f"{peer['exchanges']}")
        print(f"{tag} rank {peer['rank']} {peer['cache']}")
    print(f"{tag} {out['tok_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms, max "
          f"{out['ttft_max_ms']:.1f} ms ({name}; client side through the tunnel; "
          f"both ranks on one card over gloo: no interconnect measured)")
    free_engine(engine)
    return out


def sp_logits_run(run: MeshRun, cfg, params, ref: dict, tokens, tag: str) -> None:
    """12a / 12d: the prefill under ``run``'s mesh in each mode against the
    one-rank reference ``ref`` on the same weights; each rank's kernel-1
    check holds."""
    import dataclasses

    mesh = run.mesh
    heads = None
    if mesh.tp > 1:
        kh = cfg.n_kv_heads // mesh.tp
        heads = slice(mesh.tp_rank * kh, (mesh.tp_rank + 1) * kh)
    for mode in ("ring", "ulysses"):
        run.ctl.send("sp_logits", (mode, tokens))
        got = sp_prefill(dataclasses.replace(cfg, sp_mode=mode), params, mesh, tokens)
        peers = run.reports("sp_logits")
        print(f"{tag} {mode} tp {mesh.tp} x sp {mesh.sp} vs one rank ({cfg.n_layers} "
              f"layers, T {SP_T}, the same weights): {compare_logits(tag, got, ref, heads)}")
        ranks = [got] + peers
        print(f"{tag} {mode}: kernel 1 launches per rank "
              f"{[r['k1'] for r in ranks]} (each rank checked: "
              f"{cfg.n_layers if mode == 'ulysses' else 0}); peak memory per rank "
              f"{[round(r['peak_gb'], 3) for r in ranks]} GB; exchanges rank 0 "
              f"{got['exchanges']}; prefill wall ms per rank "
              f"{[round(r['wall_ms'], 1) for r in ranks]}, of it in the exchanges' "
              f"all-reduces {[round(r['exchange_ms'], 1) for r in ranks]} (one rank "
              f"alone: {ref['wall_ms']:.1f} ms; host clock, synchronized)")


def sp_phase(name: str, add_launches) -> None:
    """Phase 12: sequence parallelism at llama3-8b's full width, ranks on
    the one card (spawned processes, as ``tunnel-gpu serve --sp 2`` starts
    them; gloo, every exchange a zero-padded all-reduce through the host):
    (a) sp 2 prefill logits, ring and Ulysses, against one rank's forward
    on the same weights at T 4096; (b) ``--sp 2 --sp-mode ring`` on the
    serve defaults (fenced to mux with whole-prompt waves), bf16 KV; (c)
    ``--sp 2 --sp-mode ulysses --kv-quant int4 --fused-decode-layer``; (d)
    tp 2 x sp 2 logits over four ranks (depth cut to ``SP_TP_LAYERS``)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import init_params
    from p2p_llm_tunnel_tpu_torch.parallel import shard_params

    # Earlier phases' engines can outlive their names in reference cycles
    # (11d's counting wrappers close over the replicas' own methods, 2 x
    # 16 GB of weights): collect them before more ranks share the card.
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MODEL)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, SP_T).astype(np.int64)
    run = MeshRun(1, SP)
    try:
        print(f"[12] --sp {SP}: rank 0 here, rank 1 a spawned process, on "
              f"{torch.cuda.device_count()} card(s): backend {run.backend} (ranks "
              f"share a card), every exchange a zero-padded all-reduce; sp on one "
              f"card measures no interconnect")
        full = init_params(cfg, 0, torch.bfloat16, DEVICE)
        run.ctl.send("weights", (True, None))
        ref = sp_prefill(cfg, full, None, tokens)
        sp_logits_run(run, cfg, full, ref, tokens, "[12a]")
        del ref
        m = sp_engine_run(run, full, cfg, ("--sp-mode", "ring"), "[12b]", name)
        add_launches(m["launches"])
        m = sp_engine_run(run, full, cfg, ("--sp-mode", "ulysses", "--kv-quant", "int4",
                                           "--fused-decode-layer"), "[12c]", name)
        add_launches(m["launches"])
        run.ctl.send("weights", (False, None))
        del full
        torch.cuda.empty_cache()
        run.close()
    finally:
        run.close(clean=False)
    # 12d: tp 2 x sp 2 over four ranks, at a cut depth.
    cfg_d = dataclasses.replace(cfg, n_layers=SP_TP_LAYERS)
    run = MeshRun(2, SP)
    try:
        full = init_params(cfg_d, 0, torch.bfloat16, DEVICE)
        run.ctl.send("weights", (True, SP_TP_LAYERS))
        ref = sp_prefill(cfg_d, full, None, tokens)
        shard = shard_params(full, cfg_d, run.mesh)
        del full
        sp_logits_run(run, cfg_d, shard, ref, tokens, "[12d]")
        del shard, ref
        run.ctl.send("weights", (False, None))
        torch.cuda.empty_cache()
        run.close()
    finally:
        run.close(clean=False)


#: 12e (``--sp-nccl``): sp over this many cards, a rank a card (NCCL).
SP_NCCL = 4
#: Calls a timed pass of one exchange in 12e (after 3 untimed).
SP_BENCH_REPS = 20


def exchange_cases(cfg, sp: int, t: int) -> list:
    """Each exchange at the shapes one ``t``-token prefill of ``cfg`` gives
    it over ``sp`` ranks (one call's input), and the tp logits gather of a
    decode step of ``NUM_SLOTS`` rows over as many ranks: ``(label,
    exchange, its axes, shape, dtype)``."""
    import torch

    tl, h, kh, d = t // sp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    return [
        ("ring_shift, a K or V block", "ring_shift", (), (1, tl, kh, d), bf16),
        ("all_to_all seq->heads, q", "all_to_all", (2, 1), (1, tl, h, d), bf16),
        ("all_to_all seq->heads, K or V", "all_to_all", (2, 1), (1, tl, kh, d), bf16),
        ("all_to_all heads->seq, the output", "all_to_all", (1, 2),
         (1, t, h // sp, d), bf16),
        ("all_gather, a layer's K or V", "all_gather", (1,), (1, tl, kh, d), bf16),
        ("all_gather, the last hidden states", "all_gather", (1,), (1, tl, cfg.dim),
         bf16),
        (f"all_gather, tp {sp}'s logits of a decode step", "all_gather", (-1,),
         (NUM_SLOTS, 1, cfg.vocab_size // sp), torch.float32),
    ]


def library_exchange(op: str, x, group, *axes):
    """The library's own collective for the function the port's exchange
    ``op`` computes (12e's comparison; used nowhere in the port):
    ``batch_isend_irecv`` for the ring shift, ``all_to_all_single`` for the
    tiled all-to-all, ``all_gather_into_tensor`` for the gather."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    if op == "ring_shift":
        send, recv = x.contiguous(), torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (r + 1) % n), group),
               dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (r - 1) % n), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv
    if op == "all_to_all":
        split, concat = axes
        send = torch.stack(x.tensor_split(n, dim=split))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat(recv.unbind(0), dim=concat)
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out.flatten(0, 1), x.contiguous(), group=group)
    return torch.cat(out.unbind(0), dim=axes[0])


def exchange_bench(cfg, mesh, t: int) -> dict:
    """Every rank's half of 12e's exchange timing: each case of
    ``exchange_cases`` over the sp group, the port's exchange against the
    library's collective, in passes port, library, library, port of
    ``SP_BENCH_REPS`` calls each (3 untimed first; host clock, the card
    synchronized around each pass): ms a call per pass, and whether the
    two give the same bytes on this rank."""
    import torch

    from p2p_llm_tunnel_tpu_torch.parallel import collectives
    from p2p_llm_tunnel_tpu_torch.parallel.distributed import rank_device

    dev = rank_device(DEVICE, mesh.rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    gen = torch.Generator().manual_seed(1000 + mesh.rank)
    rows = []
    for label, op, axes, shape, dtype in exchange_cases(cfg, mesh.sp, t):
        x = torch.randn(shape, generator=gen).to(dev, dtype)
        fns = {"port": lambda: getattr(collectives, op)(x, *axes, mesh.sp_group),
               "library": lambda: library_exchange(op, x, mesh.sp_group, *axes)}
        ms, out = {"port": [], "library": []}, {}
        for who in ("port", "library", "library", "port"):
            for _ in range(3):
                out[who] = fns[who]()
            sync(dev)
            t0 = time.monotonic()
            for _ in range(SP_BENCH_REPS):
                fns[who]()
            sync(dev)
            ms[who].append((time.monotonic() - t0) / SP_BENCH_REPS * 1e3)
        a, b = (out[w].contiguous().view(torch.uint8) for w in ("port", "library"))
        rows.append(dict(label=label, shape=shape, dtype=str(dtype).split(".")[-1],
                         mib=x.numel() * x.element_size() / 2**20, ms=ms,
                         bitwise=bool(torch.equal(a, b))))
    return dict(rank=mesh.rank, rows=rows)


def sp_nccl_phase(name: str) -> None:
    """Phase 12e (``--sp-nccl``, ``SP_NCCL`` cards): sp over a card a rank,
    so the sp group is NCCL.  (a) Each exchange at the shapes of one
    ``SP_T``-token prefill of llama3-8b against the library's collective
    for the same function (``library_exchange``): ms a call, and the same
    bytes on every rank.  (b) That prefill at full width, ring and
    Ulysses, three passes (the first warms up), against one rank's on the
    same weights (11b's bound; its second pass timed): wall ms."""
    import dataclasses

    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import init_params

    cards = torch.cuda.device_count()
    if cards < SP_NCCL:
        raise AssertionError(f"--sp-nccl needs {SP_NCCL} cards, this machine has {cards}")
    cfg = get_config(MODEL)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, SP_T).astype(np.int64)
    run = MeshRun(1, SP_NCCL)
    try:
        if run.backend != "nccl":
            raise AssertionError(f"[12e] backend {run.backend}, not NCCL")
        print(f"[12e] --sp {SP_NCCL}: rank 0 here, ranks 1-{SP_NCCL - 1} spawned, a "
              f"card a rank ({cards} cards): backend {run.backend}")
        run.ctl.send("sp_bench", (SP_T,))
        mine = exchange_bench(cfg, run.mesh, SP_T)
        ranks = [mine] + run.reports("sp_bench")
        for i, row in enumerate(mine["rows"]):
            per_rank = [r["rows"][i] for r in ranks]
            if not all(r["bitwise"] for r in per_rank):
                raise AssertionError(f"[12e] {row['label']}: the port's exchange and "
                                     f"the library's differ on ranks "
                                     f"{[r['bitwise'] for r in per_rank]}")
            passes = [max(r["ms"][w][k] for r in per_rank)
                      for w, k in (("port", 0), ("library", 0), ("library", 1),
                                   ("port", 1))]
            print(f"[12e] {row['label']} {row['shape']} {row['dtype']} "
                  f"({row['mib']:.2f} MiB a rank): ms a call, slowest rank, passes "
                  f"port/library/library/port {passes}; port / library "
                  f"{(passes[0] + passes[3]) / (passes[1] + passes[2]):.4f}; the same "
                  f"bytes on every rank ({name})")
        full = init_params(cfg, 0, torch.bfloat16, DEVICE)
        run.ctl.send("weights", (True, None))
        ref = [sp_prefill(cfg, full, None, tokens, timed=False) for _ in range(2)][1]
        for mode in ("ring", "ulysses"):
            mcfg, wall = dataclasses.replace(cfg, sp_mode=mode), []
            for _ in range(3):
                run.ctl.send("sp_logits", (mode, tokens, False))
                got = sp_prefill(mcfg, full, run.mesh, tokens, timed=False)
                peers = run.reports("sp_logits")
                wall.append(max([got["wall_ms"]] + [p["wall_ms"] for p in peers]))
            print(f"[12e] {mode} sp {SP_NCCL} (NCCL) vs one rank ({cfg.n_layers} layers, "
                  f"T {SP_T}): {compare_logits('[12e]', got, ref)}")
            print(f"[12e] {mode}: prefill wall ms, slowest rank, passes {wall} (the "
                  f"first warms up); one rank alone {ref['wall_ms']} ms; exchanges "
                  f"rank 0 {got['exchanges']}; kernel 1 launches rank 0 {got['k1']} "
                  f"(checked on each rank); peak memory rank 0 {got['peak_gb']:.3f} GB "
                  f"({name})")
        run.ctl.send("weights", (False, None))
        del full
        torch.cuda.empty_cache()
        run.close()
    finally:
        run.close(clean=False)


# ---------------------------------------------------------------------------
# phase 13: expert parallelism (--ep) and data parallelism (--dp-dcn)
# ---------------------------------------------------------------------------

EP = 2
#: 13a / 13c / 13e: one prompt of EP_T tokens prefilled at mixtral's widths
#: cut to MOE_LAYERS (the whole bf16 tree, 23.5 GB, is one rank's reference).
EP_T = 1024
#: 13d: --dp-dcn 2 over DP_SLOTS slots: 16 cache rows with the scratch
#: row, 8 a rank (num_slots + 1 must divide over dp, as the reference's
#: device_put of the cache requires); DP_CONV conversations, so both ranks'
#: slots serve (slots are taken lowest first: 0-7 are rank 0's), and a pool
#: of DP_POOL blocks that holds their working set (the default 128 evicts
#: the shared system prompt's pages under 12 conversations).
DP, DP_SLOTS, DP_CONV, DP_POOL = 2, 15, 12, 256
DP_FLAGS = ("--dp-dcn", str(DP), "--slots", str(DP_SLOTS),
            "--prefix-pool-blocks", str(DP_POOL))
#: 13e (``--ep-nccl``): mixtral-8x7b at full depth over this many cards.
EP_NCCL = 4
#: 13e's all-reduce shapes: a decode step's [16 slots + scratch, 1, Dm] and
#: a 1024-token wave's [1, 1024, Dm], f32 (moe_mlp sums before the cast).
EP_BENCH_ROWS = (NUM_SLOTS + 1, RAGGED_TOT)
EP_BENCH_REPS = 20
_MOE_LEAVES = ("router", "moe_gate", "moe_up", "moe_down")


def kv_bytes(engine) -> int:
    """The bytes of the engine's KV cache (this rank's block)."""
    return sum(x.numel() * x.element_size() for x in engine.kv_cache.values())


def weight_gb(engine) -> float:
    """The engine's weights on this rank (its shard), in GB."""
    from p2p_llm_tunnel_tpu_torch.models.quant import weight_bytes

    return weight_bytes(engine.params) / 1e9


def expert_bytes(params) -> int:
    return sum(params["blocks"][k].numel() * params["blocks"][k].element_size()
               for k in _MOE_LEAVES[1:])


def dp_engine(cfg, flags, coordinator: str, world: int):
    """The engine ``tunnel-gpu serve --backend gpu --coordinator ...
    --num-processes world --process-id <this rank> <flags>`` builds: the
    CLI joins the run (already joined here: a no-op for the same world)
    and builds the hybrid mesh of ``--dp-dcn``; the engine draws its own
    weights from seed 0."""
    import torch.distributed as dist

    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer

    args = cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", MODEL,
        "--device", DEVICE, "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ),
        "--coordinator", coordinator, "--num-processes", str(world),
        "--process-id", str(dist.get_rank()), *flags])
    ecfg = cli._engine_config(args)
    mesh, dev = cli._join_ranks(args, None)
    return InferenceEngine(engine_cfg=ecfg, mesh=mesh, device=dev,
                           tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size))


def warm_prefill(cfg, params, mesh, tokens) -> dict:
    """``sp_prefill`` twice, the first untimed (the card's libraries warm
    up on a rank's first forward): the second's report."""
    sp_prefill(cfg, params, mesh, tokens, timed=False)
    return sp_prefill(cfg, params, mesh, tokens, timed=False)


def follow_ep_prefill(shard, cfg, mesh, tokens) -> dict:
    """A follower's half of 13a / 13c / 13e: the prefill on this rank's
    shard; its report (kernel-1 check included)."""
    out = warm_prefill(cfg, shard, mesh, tokens)
    return dict(rank=mesh.rank, k1=out["k1"], peak_gb=out["peak_gb"],
                wall_ms=out["wall_ms"], experts_gb=expert_bytes(shard) / 1e9)


def ep_allreduce_bench(mesh, dm: int) -> dict:
    """13e: the ep all-reduce ``moe_mlp`` runs once a layer — f32 ``[rows,
    Dm]`` over the ep group — at a decode step's rows and a 1024-token
    wave's, ms a call (host clock around ``EP_BENCH_REPS`` calls after
    three untimed ones, the card synchronized around them; every rank
    calls it)."""
    import torch
    import torch.distributed as dist

    from p2p_llm_tunnel_tpu_torch.parallel.distributed import rank_device

    dev = rank_device(DEVICE, mesh.rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    out = {}
    for rows in EP_BENCH_ROWS:
        x = torch.randn((rows, dm), dtype=torch.float32, device=dev)
        for _ in range(3):
            dist.all_reduce(x, group=mesh.ep_group)
        sync(dev)
        t0 = time.monotonic()
        for _ in range(EP_BENCH_REPS):
            dist.all_reduce(x, group=mesh.ep_group)
        sync(dev)
        out[rows] = (time.monotonic() - t0) / EP_BENCH_REPS * 1e3
    return dict(rank=mesh.rank, ms=out)


def ep_logits_run(run, cfg, ref: dict, tokens, tag: str, experts_ep1: float) -> None:
    """13a / 13c / 13e: every rank draws its shard of the seed-0 tree at
    ``cfg``'s depth and prefills the prompt on it; rank 0's logits against
    the one-rank reference ``ref`` (11b's bound, K/V of this rank's tp
    heads printed), each rank's kernel-1 check, its expert bytes (1/ep of
    ``experts_ep1``) and peak memory."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    mesh = run.mesh
    run.ctl.send("shard", (MOE_MODEL, cfg.n_layers))
    shard = tr.init_params(cfg, 0, torch.bfloat16, DEVICE, mesh=mesh)
    run.ctl.send("ep_logits", (tokens,))
    got = warm_prefill(cfg, shard, mesh, tokens)
    ranks = [dict(rank=0, k1=got["k1"], peak_gb=got["peak_gb"], wall_ms=got["wall_ms"],
                  experts_gb=expert_bytes(shard) / 1e9)] + run.reports("ep_logits")
    del shard
    heads = None
    if mesh.tp > 1:
        kh = cfg.n_kv_heads // mesh.tp
        heads = slice(mesh.tp_rank * kh, (mesh.tp_rank + 1) * kh)
    for r in ranks:
        if abs(r["experts_gb"] * mesh.ep - experts_ep1) > 1e-6:
            raise AssertionError(f"{tag} rank {r['rank']} holds {r['experts_gb']:.4f} GB "
                                 f"of experts, not 1/{mesh.ep} of {experts_ep1:.4f}")
    print(f"{tag} tp {mesh.tp} x ep {mesh.ep} vs one rank ({cfg.n_layers} layers, T "
          f"{len(tokens)}, the same seed-0 weights): {compare_logits(tag, got, ref, heads)}")
    print(f"{tag} expert bytes per rank {[round(r['experts_gb'], 4) for r in ranks]} GB "
          f"(ep 1: {experts_ep1:.4f} GB, 1/{mesh.ep} each); kernel 1 launches per rank "
          f"{[r['k1'] for r in ranks]} (each checked: {cfg.n_layers}); peak memory per "
          f"rank {[round(r['peak_gb'], 3) for r in ranks]} GB; prefill wall ms per rank "
          f"{[round(r['wall_ms'], 1) for r in ranks]} (one rank alone "
          f"{ref['wall_ms']:.1f} ms; host clock, synchronized)")
    run.ctl.send("shard", ())


def ep_reference(cfg, tokens, tag: str):
    """The one-rank reference of 13a / 13c / 13e: rank 0 draws the whole
    seed-0 tree at ``cfg``'s depth (its followers hold nothing yet) and
    prefills the prompt; returns (the prefill report, expert GB)."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr

    full = tr.init_params(cfg, 0, torch.bfloat16, DEVICE)
    experts = expert_bytes(full) / 1e9
    ref = warm_prefill(cfg, full, None, tokens)
    del full
    torch.cuda.empty_cache()
    print(f"{tag} one rank, the whole tree ({cfg.n_layers} layers): experts "
          f"{experts:.4f} GB, prefill {ref['wall_ms']:.1f} ms, peak "
          f"{ref['peak_gb']:.3f} GB")
    return ref, experts


def mesh_engine_run(run, flags, phase, tag: str, name: str, model=None,
                    layers=None, dp: bool = False) -> dict:
    """One phase-13 engine: every follower builds it from the same flags
    (``dp``: through the serve CLI's ``--coordinator`` flags), rank 0
    builds it and serves ``phase`` through the tunnel; every rank checks
    its own launches and replayed every step; returns rank 0's result and
    the followers' reports."""
    import dataclasses

    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    cfg = get_config(model or MODEL)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dp:
        run.ctl.send("dp_engine", (flags,))
        engine = dp_engine(cfg, flags, run.coordinator, run.world)
    else:
        run.ctl.send("engine", (flags, (), model, layers))
        engine = cli_engine(None, cfg, *flags, model=model or MODEL,
                            depth_cut=bool(layers))
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)
    t_ready, out = run_engine(engine, phase)
    peers = run.reports("engine")
    out["cache"] = check_sp_cache(engine, out["waves_rec"]) if dp else None
    out.update(peak_gb=peak_gb(engine.device), kv_rows=int(engine.kv_cache["k"].shape[1]),
               kv_bytes=kv_bytes(engine), weights_gb=weight_gb(engine))
    for peer in peers:
        if out["steps"] > peer["steps"]:
            raise AssertionError(f"{tag} rank {peer['rank']} replayed {peer['steps']} "
                                 f"decode steps; rank 0 served {out['steps']}")
    ec = engine.ecfg
    print(f"{tag} {' '.join(flags)}: ready in {t_ready:.1f} s; mesh {engine.mesh.shape}; "
          f"{cfg.n_layers} layers; fences {[f['knob'] for f in engine.config_fences]}; "
          f"kv_quant {ec.kv_quant}, fused decode layer {engine.mcfg.fused_decode_layer}, "
          f"ragged {ec.ragged_prefill}, spec_ngram {ec.spec_ngram}, quant {ec.quant}")
    ranks = [dict(rank=0, waves=out["waves"], dispatches=out["dispatches"],
                  steps=out["steps"], spec=out["spec"], peak_gb=out["peak_gb"],
                  kv_rows=out["kv_rows"], kv_bytes=out["kv_bytes"], cache=out["cache"],
                  weights_gb=out["weights_gb"],
                  launches={k: v for k, v in out["launches"].items() if v})] + peers
    for r in ranks:
        print(f"{tag} rank {r['rank']}: {r['waves']} prefill waves, {r['dispatches']} "
              f"ragged dispatches, {r['steps']} decode steps, {r['spec']} verify "
              f"bursts (followers: warmup included), launch counts {r['launches']} "
              f"(checked on the rank: the decode kernel {cfg.n_layers} a step, kernel "
              f"6 {cfg.n_layers} a dispatch, kernel 1 {cfg.n_layers} a wave); cache "
              f"rows {r['kv_rows']}, {r['kv_bytes'] / 1e9:.4f} GB; weights "
              f"{r['weights_gb']:.3f} GB; peak memory {r['peak_gb']:.3f} GB")
        if r["cache"]:
            print(f"{tag} rank {r['rank']} {r['cache']}")
    print(f"{tag} {out['tok_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms, max "
          f"{out['ttft_max_ms']:.1f} ms ({name}; client side through the tunnel)")
    if ec.quant not in ("none", ""):
        print_quant_launches(tag, out, engine)
    out["ranks"] = ranks
    free_engine(engine)
    return out


async def dp_phase_run(engine) -> dict:
    """13d on rank 0: ``DP_CONV`` conversations on the dp engine, then one
    whole-prompt wave into every slot (both ranks' rows) for the cache
    check (``check_sp_cache``: each rank's rows against one rank's
    ``prefill_into_cache`` of the whole wave)."""
    import numpy as np

    from p2p_llm_tunnel_tpu_torch.engine import sampling

    out = await mux_phase(engine, n_conv=DP_CONV)
    if engine.device.type == "cuda" and out["dispatches"] == 0 and engine.ecfg.ragged_prefill:
        raise AssertionError("13d rank 0 ran no ragged dispatch")
    out["waves_rec"] = record_waves(engine)
    n, t = DP_SLOTS, 256
    rng = np.random.default_rng(13)
    tokens = rng.integers(1, engine.mcfg.vocab_size, (n, t)).astype(np.int32)
    lengths = rng.integers(t // 2, t + 1, n).astype(np.int32)
    slots = np.arange(n, dtype=np.int64)
    samp = sampling.make_params(n)

    def wave():
        import torch

        with torch.inference_mode():
            engine._dispatch("prefill", tokens, lengths, slots, samp)
        engine._sync()

    await asyncio.get_running_loop().run_in_executor(engine._executor, wave)
    return out


def ep_phase(name: str, add_launches) -> None:
    """Phase 13: expert and data parallelism, ranks on the one card
    (spawned processes, gloo): (a) mixtral-8x7b's widths at 8 layers, ep 2
    prefill logits against one rank's, each rank half the experts; (b) ep
    2 on the serve defaults + ``--ragged-prefill``; (c) tp 2 x ep 2 logits
    over four ranks; (d) llama3-8b at full width and depth, ``--dp-dcn 2``
    through the serve CLI's ``--coordinator`` flags: the serve defaults +
    ragged, ``--kv-quant int4 --fused-decode-layer --spec-ngram 3`` and
    ``--quant int4``, each rank half the cache rows, its rows against one
    rank's and its own launch checks."""
    import gc

    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    gc.collect()
    torch.cuda.empty_cache()
    cfg8 = get_config(MOE_MODEL, n_layers=MOE_LAYERS)
    tokens = np.random.default_rng(13).integers(0, cfg8.vocab_size, EP_T).astype(np.int64)
    t0 = time.monotonic()
    ref, experts = ep_reference(cfg8, tokens, "[13a]")
    run = MeshRun(1, 1, ep=EP)
    try:
        print(f"[13] --ep {EP}: rank 0 here, rank 1 a spawned process, on "
              f"{torch.cuda.device_count()} card(s): backend {run.backend} (ranks "
              f"share a card: NCCL refuses two ranks on one GPU); the ep sum an "
              f"all-reduce through the host; no interconnect measured")
        ep_logits_run(run, cfg8, ref, tokens, "[13a]", experts)
        print(f"[13a] {time.monotonic() - t0:.1f} s ({name})")
        t0 = time.monotonic()
        m = mesh_engine_run(run, ("--ep", str(EP), "--ragged-prefill"), mux_phase,
                            "[13b]", name, model=MOE_MODEL, layers=MOE_LAYERS)
        add_launches(m["launches"])
        print(f"[13b] {time.monotonic() - t0:.1f} s ({name})")
        run.close()
    finally:
        run.close(clean=False)
    t0 = time.monotonic()
    run = MeshRun(2, 1, ep=EP)
    try:
        ep_logits_run(run, cfg8, ref, tokens, "[13c]", experts)
        run.close()
    finally:
        run.close(clean=False)
    print(f"[13c] {time.monotonic() - t0:.1f} s ({name})")
    del ref
    # 13d's yardstick: the same slots, pool and conversations on one rank.
    t0 = time.monotonic()
    cfg = get_config(MODEL)
    one = cli_engine(None, cfg, *DP_FLAGS[2:], "--ragged-prefill", model=MODEL)
    t_ready, m = run_engine(one, lambda e: mux_phase(e, n_conv=DP_CONV))
    add_launches(m["launches"])
    print(f"[13d] dp 1 yardstick, {' '.join(DP_FLAGS[2:])} --ragged-prefill on one "
          f"rank: {DP_CONV} conversations, {m['tok_s']:.1f} tok/s, TTFT p50 "
          f"{m['ttft_p50_ms']:.1f} ms, cache {kv_bytes(one) / 1e9:.4f} GB; "
          f"{time.monotonic() - t0:.1f} s ({name})")
    free_engine(one)
    del one
    run = MeshRun(1, 1, dp=DP)
    try:
        for flags in (("--ragged-prefill",),
                      ("--kv-quant", "int4", "--fused-decode-layer", "--spec-ngram", "3"),
                      ("--quant", "int4")):
            t0 = time.monotonic()
            m = mesh_engine_run(run, DP_FLAGS + flags, dp_phase_run, "[13d]", name,
                                dp=True)
            add_launches(m["launches"])
            full_rows = DP_SLOTS + 1
            for r in m["ranks"]:
                if r["kv_rows"] * DP != full_rows:
                    raise AssertionError(f"[13d] rank {r['rank']} holds {r['kv_rows']} "
                                         f"cache rows, not {full_rows} / {DP}")
            print(f"[13d] each rank holds {m['kv_rows']} of {full_rows} cache rows: "
                  f"{m['kv_bytes'] / 1e9:.4f} GB, half of dp 1's "
                  f"{m['kv_bytes'] * DP / 1e9:.4f} GB; {time.monotonic() - t0:.1f} s "
                  f"({name})")
        run.close()
    finally:
        run.close(clean=False)


def ep_nccl_phase(name: str) -> None:
    """13e (``--ep-nccl``, four cards, a card a rank, NCCL): at 8 layers, ep
    4 logits against one rank's; the ep all-reduce's ms a call at a
    decode step's and a 1024-token wave's shapes; then mixtral-8x7b at
    full depth (32 layers) at ep 4 serving phase 5's conversations on the
    serve defaults + ``--ragged-prefill`` — tok/s, TTFT p50 and each
    card's peak memory."""
    import numpy as np
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    if torch.cuda.device_count() < EP_NCCL:
        raise AssertionError(f"--ep-nccl needs {EP_NCCL} cards, have "
                             f"{torch.cuda.device_count()}")
    cfg8 = get_config(MOE_MODEL, n_layers=MOE_LAYERS)
    tokens = np.random.default_rng(13).integers(0, cfg8.vocab_size, EP_T).astype(np.int64)
    ref, experts = ep_reference(cfg8, tokens, "[13e]")
    run = MeshRun(1, 1, ep=EP_NCCL)
    try:
        print(f"[13e] --ep {EP_NCCL}: a card a rank, backend {run.backend}")
        if run.backend != "nccl":
            raise AssertionError(f"[13e] joined over {run.backend}, not nccl")
        ep_logits_run(run, cfg8, ref, tokens, "[13e]", experts)
        run.ctl.send("ep_bench", (cfg8.dim,))
        mine = ep_allreduce_bench(run.mesh, cfg8.dim)
        ranks = [mine] + run.reports("ep_bench")
        for rows in EP_BENCH_ROWS:
            ms = [r["ms"][rows] for r in ranks]
            what = "decode step" if rows == EP_BENCH_ROWS[0] else f"{rows}-token wave"
            print(f"[13e] ep all-reduce of f32 [{rows}, {cfg8.dim}] (one a layer, a "
                  f"{what}): {max(ms):.4f} ms a call on the slowest rank, per rank "
                  f"{[round(x, 4) for x in ms]} ({name}, NCCL; host clock over "
                  f"{EP_BENCH_REPS} calls, synchronized)")
        full = get_config(MOE_MODEL)
        m = mesh_engine_run(run, ("--ep", str(EP_NCCL), "--ragged-prefill"), mux_phase,
                            "[13e]", name, model=MOE_MODEL)
        print(f"[13e] {MOE_MODEL} at full depth ({full.n_layers} layers) over "
              f"{EP_NCCL} cards: {m['tok_s']:.1f} tok/s, TTFT p50 "
              f"{m['ttft_p50_ms']:.1f} ms; weights per card "
              f"{[round(r['weights_gb'], 3) for r in m['ranks']]} GB, peak memory "
              f"per card {[round(r['peak_gb'], 3) for r in m['ranks']]} GB ({name})")
        run.close()
    finally:
        run.close(clean=False)


# ---------------------------------------------------------------------------
# Phase 14: training (loss_fn, the dp x tp AdamW step, the GPipe pipeline)
# ---------------------------------------------------------------------------

#: The model phase 14 trains: fp32 weights and AdamW moments take 16 bytes
#: a parameter, ~20 GB at llama3.2-1b's full width and depth (llama3-8b's
#: ~128 GB fits no card).
TRAIN_MODEL = "llama3.2-1b"
TRAIN_B, TRAIN_T = 8, 256
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
#: Right-padded lengths of the training batch's rows (ragged).
TRAIN_LENGTHS = (256, 200, 131, 256, 64, 17, 240, 100)
#: 14a's head geometries (H, K, D): llama3-8b's and llama3.2-1b's.
TRAIN_HEADS = ((32, 8, 128), (32, 8, 64))
#: 14c's depth cut (dp 2 x tp 2, four ranks on the one card).
TRAIN_DPTP_LAYERS = 4
TRAIN_PP, TRAIN_MICRO = 2, 4
TRAIN_TIMEOUT_S = 600.0
#: 14b against the plain attention with the Function's casts (bf16-rounded
#: inputs and output, an fp32 backward): the loss's absolute difference,
#: and each leaf's gradient within this share of its max |g|.  Only the
#: kernel's forward differs (it rounds P to bf16 for PV).  A few times the
#: worst reading (PERF.md, section 6).
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 2e-2
#: 14c / 14d against one rank's whole-tree step: the same attention, other
#: product shapes (tp shards, microbatches), so only rounding differs,
#: which kernel 1's bf16 copies can amplify.  A few times the worst reading.
MESH_LOSS_TOL, MESH_GRAD_TOL = 5e-4, 1e-2
#: 14a: the Function's gradient is the plain version's recomputed, so only
#: the order of the sums can differ.
K1_GRAD_TOL = 1e-3
TRAIN_LEAVES = ("embed", "blocks.wq", "blocks.w_down", "final_norm")


def train_batch(vocab: int, device, b: int = TRAIN_B, t: int = TRAIN_T,
                lengths=TRAIN_LENGTHS):
    """A fixed right-padded batch from seed 14: tokens, next-token targets
    and the valid mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(14)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int64)
    valid = np.arange(t)[None, :] < np.asarray(lengths[:b])[:, None]
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(np.roll(tokens, -1, axis=1), device=device),
            torch.as_tensor(valid, device=device))


def flat(tree, path: str = "") -> dict:
    """A params tree's leaves by dotted path."""
    if not isinstance(tree, dict):
        return {path: tree}
    return {k: v for name, sub in tree.items()
            for k, v in flat(sub, f"{path}.{name}" if path else name).items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Per leaf path: max |got - want| / max |want|."""
    return {k: ((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30)).item()
            for k in want}


def kernel1_grad_case(h: int, kh: int, d: int, name: str) -> dict:
    """14a at one head geometry: the Function (kernel 1 forward, the plain
    version's gradient) against a direct launch and against the plain
    version's gradient on the same bf16-rounded inputs, at B 8, T 256 with
    ragged lengths; forward / backward / plain-forward ms."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
    from p2p_llm_tunnel_tpu_torch.ops.attention import causal_attention

    g = torch.Generator(device="cuda").manual_seed(h * d)
    b, t = TRAIN_B, TRAIN_T
    q, k, v = (torch.randn(s, generator=g, device="cuda").requires_grad_(True)
               for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    valid = (torch.arange(t, device="cuda")[None, :]
             < torch.tensor(TRAIN_LENGTHS, device="cuda")[:, None])
    dout = torch.randn((b, t, h, d), generator=g, device="cuda")
    out = fa.flash_causal_attention(q, k, v, valid)
    if out.grad_fn is None or "AttentionGrad" not in type(out.grad_fn).__name__:
        raise AssertionError("[14a] the wrapper did not enter the autograd Function")
    with torch.no_grad():
        direct = fa.flash_causal_attention(*(x.detach().bfloat16() for x in (q, k, v)),
                                           valid)
    if not torch.equal(out, direct.float()):
        raise AssertionError("[14a] the Function's forward is not the direct launch")
    grads = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    leaves = [x.detach().bfloat16().float().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(causal_attention(*leaves, valid), leaves, dout)
    errs = {n: (a - r).abs().max().item() for n, a, r in zip("qkv", grads, ref)}
    scale = {n: r.abs().max().item() for n, r in zip("qkv", ref)}
    for n in "qkv":
        if errs[n] > K1_GRAD_TOL * scale[n]:
            raise AssertionError(f"[14a] H{h} K{kh} D{d}: d{n} off by {errs[n]:.3g} > "
                                 f"{K1_GRAD_TOL} x max |d{n}| {scale[n]:.3g}")
    fwd = timed_ms(lambda: fa.flash_causal_attention(q, k, v, valid))
    bwd = timed_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True))
    qb, kb, vb = (x.detach().bfloat16() for x in (q, k, v))
    with torch.no_grad():
        plain = timed_ms(lambda: causal_attention(qb, kb, vb, valid))
    print(f"[14a] kernel 1 under autograd, B {b} T {t} H {h} K {kh} D {d}, lengths "
          f"{list(TRAIN_LENGTHS)}: forward bitwise the direct launch; max |grad - "
          f"plain grad| dq {errs['q']:.3g} dk {errs['k']:.3g} dv {errs['v']:.3g} "
          f"(bound {K1_GRAD_TOL} x max |g|: {scale['q']:.3g}, {scale['k']:.3g}, "
          f"{scale['v']:.3g}); forward {fwd[0]:.4f} ms (spread {fwd[1]:.4f}; kernel "
          f"+ bf16 copies), backward {bwd[0]:.4f} ms (spread {bwd[1]:.4f}; the plain "
          f"recompute), plain forward {plain[0]:.4f} ms ({name}; CUDA events)")
    return dict(fwd_ms=fwd[0], bwd_ms=bwd[0], plain_ms=plain[0])


def plain_bf16_attention(q, k, v, valid, **kw):
    """The plain version with the Function's casts: in the inputs' dtype on
    their bf16-rounded values, its output rounded to bf16.  Each rounding
    passes the gradient through unchanged, as the Function's backward
    does, so the backward runs wholly in the inputs' dtype."""
    from p2p_llm_tunnel_tpu_torch.ops.attention import causal_attention

    def rounded(x):
        return x + (x.bfloat16().to(x.dtype) - x).detach()

    return rounded(causal_attention(*(rounded(x) for x in (q, k, v)), valid, **kw))


def single_card_train(name: str) -> dict:
    """14b: llama3.2-1b at full width and depth, fp32 weights from seed 0,
    ``make_train_step`` at dp 1 x tp 1: step 1's loss and gradients against
    the same step with the plain attention, kernel 1 ``n_layers`` times a
    step, the loss finite at every step and descending over five."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
    from p2p_llm_tunnel_tpu_torch.parallel.train import make_train_step, param_leaves

    cfg = get_config(TRAIN_MODEL)
    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    init_fn, step_fn = make_train_step(cfg, None, lr=TRAIN_LR, device=dev)
    params, opt = init_fn(0)
    n_params = sum(x.numel() for x in param_leaves(params))
    batch = train_batch(cfg.vocab_size, dev)
    # The reference: the same forward and backward with the plain attention.
    kernel_fn, tr.flash_causal_attention = tr.flash_causal_attention, plain_bf16_attention
    try:
        ref_loss = tr.loss_fn(cfg, params, *batch)
        ref_loss.backward()
    finally:
        tr.flash_causal_attention = kernel_fn
    ref = {p: flat(params)[p].grad.clone() for p in TRAIN_LEAVES}
    ref_loss = ref_loss.item()
    opt.zero_grad(set_to_none=True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, step_ms, k1 = [], [], []
    for step in range(TRAIN_STEPS):
        fa.flash_causal_attention.launches = 0
        sync()
        t0 = time.monotonic()
        params, opt, loss = step_fn(params, opt, *batch)
        losses.append(loss.item())
        step_ms.append((time.monotonic() - t0) * 1e3)
        k1.append(fa.flash_causal_attention.launches)
        if step == 0:
            got = {p: flat(params)[p].grad for p in TRAIN_LEAVES}
            errs = grad_errors(got, ref)
            del got
    del ref
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[14b] a loss is not finite: {losses}")
    if losses[-1] >= losses[0]:
        raise AssertionError(f"[14b] the loss did not descend: {losses}")
    if abs(losses[0] - ref_loss) > TRAIN_LOSS_TOL:
        raise AssertionError(f"[14b] step 1's loss {losses[0]} is {abs(losses[0] - ref_loss):.3g} "
                             f"from the plain attention's {ref_loss}")
    bad = {k: v for k, v in errs.items() if v > TRAIN_GRAD_TOL}
    if bad:
        raise AssertionError(f"[14b] gradients off the plain attention's: {bad}")
    if dev.type == "cuda" and any(n != cfg.n_layers for n in k1):
        raise AssertionError(f"[14b] kernel 1 launches a step {k1}, not {cfg.n_layers}")
    steady = statistics.median(step_ms[1:])
    tokens = TRAIN_B * TRAIN_T
    print(f"[14b] {TRAIN_MODEL} ({cfg.n_layers} layers, dim {cfg.dim}, "
          f"{n_params / 1e9:.3f} B parameters) fp32 + AdamW, lr {TRAIN_LR}, B "
          f"{TRAIN_B} x T {TRAIN_T} ({int(batch[2].sum())} valid tokens), dp 1 x tp 1: "
          f"losses {[round(x, 5) for x in losses]}; step 1 against the plain attention "
          f"(same weights, same bf16 casts): loss {ref_loss:.6f} vs {losses[0]:.6f} "
          f"(bound {TRAIN_LOSS_TOL}), max |grad diff| / max |g| "
          f"{ {k: round(v, 6) for k, v in errs.items()} } (bound "
          f"{TRAIN_GRAD_TOL}); kernel 1 launches a step {k1}")
    print(f"[14b] {steady:.1f} ms a step (median of steps 2-{TRAIN_STEPS}; step 1 "
          f"{step_ms[0]:.1f} ms), {tokens / steady * 1e3:.0f} tokens/s ({tokens} a "
          f"step, pads included), peak memory {peak_gb(dev):.3f} GB ({name}; host "
          f"clock, synchronized)")
    del params, opt
    return dict(launches=sum(k1), step_ms=steady, tok_s=tokens / steady * 1e3,
                peak_gb=peak_gb(dev))


def train_rank(coordinator: str, rank: int, world: int, kind: str, results,
               settings: dict) -> Optional[dict]:
    """A rank of 14c (``kind`` "dptp": dp 2 x tp 2) or 14d ("pp": pp 2): on
    the one card, joined over gloo.  Every rank first takes one rank's
    whole-tree ``loss_fn`` step on the seed-0 weights (the reference),
    keeps its own part of the gradients, then runs the sharded path and
    holds it against them.  A spawned rank reports to ``results``; rank 0
    returns its report.  A failure raises (rank 0) or is reported."""
    import dataclasses
    import gc
    import traceback

    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh
    from p2p_llm_tunnel_tpu_torch.parallel.pipeline import (
        make_pp_mesh,
        pipeline_loss_fn,
        shard_params_pp,
    )
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import shard_params
    from p2p_llm_tunnel_tpu_torch.parallel.train import make_train_step, param_leaves

    globals().update(settings)
    try:
        dev = pd.rank_device(DEVICE, rank)
        backend = pd.init_distributed(coordinator, world, rank, device=dev,
                                      timeout_s=TRAIN_TIMEOUT_S)
        torch.backends.cuda.matmul.allow_tf32 = False
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        layers = TRAIN_DPTP_LAYERS if kind == "dptp" else None
        cfg = get_config(TRAIN_MODEL)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        batch = train_batch(cfg.vocab_size, dev)
        # One rank's whole-tree step: the reference, its gradients whole.
        full = tr.init_params(cfg, 0, torch.float32, dev)
        for leaf in param_leaves(full):
            leaf.requires_grad_(True)
        for _ in range(2):  # the second call is timed (warm)
            for leaf in param_leaves(full):
                leaf.grad = None
            sync()
            t0 = time.monotonic()
            ref_loss = tr.loss_fn(cfg, full, *batch)
            ref_loss.backward()
            sync()
            ref_ms = (time.monotonic() - t0) * 1e3
        ref_loss = ref_loss.item()
        ref_grads = _tree_map(full, lambda x: x.grad)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = dict(rank=rank, backend=backend, ref_loss=ref_loss, ref_ms=ref_ms)
        if kind == "dptp":
            mesh = make_mesh(tp=2, dp=2)
            want = _tree_map(shard_params(ref_grads, cfg, mesh), lambda x: x.clone())
            del full, ref_grads
            gc.collect()
            init_fn, step_fn = make_train_step(cfg, mesh, lr=TRAIN_LR, device=dev)
            params, opt = init_fn(0)
            losses, k1 = [], []
            for step in range(3):
                fa.flash_causal_attention.launches = 0
                params, opt, loss = step_fn(params, opt, *batch)
                losses.append(loss.item())
                k1.append(fa.flash_causal_attention.launches)
                if step == 0:
                    out["errs"] = grad_errors(
                        {k: x.grad for k, x in flat(params).items()}, flat(want))
                    del want
            out.update(
                loss=losses[0], losses=losses, k1=k1,
                moments=all(tuple(opt.state[x][m].shape) == tuple(x.shape)
                            for x in param_leaves(params)
                            for m in ("exp_avg", "exp_avg_sq")),
                shapes={k: tuple(flat(params)[k].shape)
                        for k in ("embed", "blocks.wq", "blocks.wo")})
        else:
            mesh = make_pp_mesh(world)
            stage = shard_params_pp(_tree_map(full, lambda x: x.detach()), mesh)
            per = cfg.n_layers // world
            want = dict(ref_grads, blocks={
                k: v[rank * per:(rank + 1) * per].clone()
                for k, v in ref_grads["blocks"].items()})
            del full, ref_grads
            gc.collect()
            for leaf in param_leaves(stage):
                leaf.requires_grad_(True)
            times, k1 = [], []
            for _ in range(3):
                for leaf in param_leaves(stage):
                    leaf.grad = None
                fa.flash_causal_attention.launches = 0
                sync()
                t0 = time.monotonic()
                loss = pipeline_loss_fn(cfg, stage, *batch, mesh, TRAIN_MICRO)
                loss.backward()
                sync()
                times.append((time.monotonic() - t0) * 1e3)
                k1.append(fa.flash_causal_attention.launches)
            out.update(loss=loss.item(), k1=k1,
                       errs=grad_errors({k: x.grad for k, x in flat(stage).items()},
                                        flat(want)),
                       ms=statistics.median(times[1:]), first_ms=times[0],
                       ticks=TRAIN_MICRO + world - 1, per_stage=per)
            del want, stage
        out["peak_gb"] = peak_gb(dev)
        if results is not None:
            results.put(("train", out))
        return out
    except BaseException:
        if results is None:
            raise
        results.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        return None
    finally:
        pd.shutdown_distributed()


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def train_mesh_run(kind: str, world: int) -> list:
    """Ranks 1..world-1 of 14c / 14d as spawned processes, rank 0 here; every
    rank's report, by rank."""
    import multiprocessing

    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    coordinator = pd.local_rendezvous()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    settings = {k: globals()[k] for k in (
        "DEVICE", "TRAIN_MODEL", "TRAIN_B", "TRAIN_T", "TRAIN_LENGTHS", "TRAIN_LR",
        "TRAIN_DPTP_LAYERS", "TRAIN_MICRO", "TRAIN_TIMEOUT_S")}
    procs = [ctx.Process(target=train_rank, name=f"train-rank-{r}", daemon=True,
                         args=(coordinator, r, world, kind, results, settings))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        mine = train_rank(coordinator, 0, world, kind, None, settings)
        import queue

        peers = []
        for _ in procs:
            try:
                what, value = results.get(timeout=TRAIN_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"[14] a {kind} rank sent no report within "
                                     f"{TRAIN_TIMEOUT_S:.0f} s") from None
            if what == "error":
                raise AssertionError(f"[14] a {kind} rank failed: {value}")
            peers.append(value)
    finally:
        for p in procs:
            p.join(60.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"[14] {kind} ranks exited {bad}")
    return sorted([mine] + peers, key=lambda r: r["rank"])


def check_mesh_ranks(tag: str, ranks: list) -> None:
    """Each rank's loss and gradients against its whole-tree reference."""
    for r in ranks:
        loss = r["loss"]
        if not math.isfinite(loss) or abs(loss - r["ref_loss"]) > MESH_LOSS_TOL:
            raise AssertionError(f"{tag} rank {r['rank']}: loss {loss} against one "
                                 f"rank's whole-tree {r['ref_loss']} (bound "
                                 f"{MESH_LOSS_TOL})")
        bad = {k: v for k, v in r["errs"].items() if v > MESH_GRAD_TOL}
        if bad:
            raise AssertionError(f"{tag} rank {r['rank']}: gradients off the whole "
                                 f"tree's by {bad} x max |g| (bound {MESH_GRAD_TOL})")


def train_phase(name: str, add_launches) -> None:
    """Phase 14: training. (a) kernel 1's gradient through its autograd
    Function at llama3-8b's and llama3.2-1b's heads; (b) llama3.2-1b at
    full width and depth, five AdamW steps on one card; (c) dp 2 x tp 2
    over four gloo ranks on the card at 4 layers; (d) pp 2 over two gloo
    ranks at full depth, ``n_micro`` 4.  Each against one rank's
    whole-tree step on the same weights."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    if torch.device(DEVICE).type == "cuda":
        for h, kh, d in TRAIN_HEADS:
            kernel1_grad_case(h, kh, d, name)
    t0 = time.monotonic()
    b = single_card_train(name)
    add_launches({"flash_causal_attention": b["launches"]})
    print(f"[14b] {time.monotonic() - t0:.1f} s ({name})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = train_mesh_run("dptp", 4)
    check_mesh_ranks("[14c]", ranks)
    for r in ranks:
        if not r["moments"]:
            raise AssertionError(f"[14c] rank {r['rank']}: a moment is not at its "
                                 "shard's shape")
        if r["losses"][-1] >= r["losses"][0]:
            raise AssertionError(f"[14c] rank {r['rank']}: losses {r['losses']} do "
                                 "not descend")
        if torch.device(DEVICE).type == "cuda" and any(
                n != TRAIN_DPTP_LAYERS for n in r["k1"]):
            raise AssertionError(f"[14c] rank {r['rank']}: kernel 1 launches a step "
                                 f"{r['k1']}, not {TRAIN_DPTP_LAYERS}")
    add_launches({"flash_causal_attention": sum(ranks[0]["k1"])})
    print(f"[14c] {TRAIN_MODEL} widths at {TRAIN_DPTP_LAYERS} layers, dp 2 x tp 2 over "
          f"four ranks on {torch.cuda.device_count()} card(s) ({name}), backend "
          f"{ranks[0]['backend']}: each rank's step-1 loss and gradients against one "
          f"rank's whole-tree step (bounds {MESH_LOSS_TOL}, {MESH_GRAD_TOL} x max |g|): "
          + "; ".join(f"rank {r['rank']} loss {r['losses'][0]:.6f} vs "
                      f"{r['ref_loss']:.6f}, worst leaf {max(r['errs'].values()):.3g}"
                      for r in ranks))
    print(f"[14c] losses over 3 steps {ranks[0]['losses']}; moments at the shard "
          f"shapes {ranks[0]['shapes']}; kernel 1 launches a step {ranks[0]['k1']}; "
          f"peak memory per rank {[round(r['peak_gb'], 3) for r in ranks]} GB; "
          f"{time.monotonic() - t0:.1f} s ({name})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = train_mesh_run("pp", TRAIN_PP)
    check_mesh_ranks("[14d]", ranks)
    for r in ranks:
        want = r["ticks"] * r["per_stage"]
        if torch.device(DEVICE).type == "cuda" and any(n != want for n in r["k1"]):
            raise AssertionError(f"[14d] rank {r['rank']}: kernel 1 launches "
                                 f"{r['k1']}, not {want} a value-and-grad")
    add_launches({"flash_causal_attention": sum(ranks[0]["k1"])})
    print(f"[14d] {TRAIN_MODEL} at full depth, pp {TRAIN_PP} ({ranks[0]['per_stage']} "
          f"layers a stage), n_micro {TRAIN_MICRO}, over two ranks on the card ({name}), "
          f"backend "
          f"{ranks[0]['backend']}: pipeline_loss_fn's loss and every leaf's gradient "
          f"against one rank's unsharded loss_fn (bounds {MESH_LOSS_TOL}, "
          f"{MESH_GRAD_TOL} x max |g|): "
          + "; ".join(f"rank {r['rank']} loss {r['loss']:.6f} vs {r['ref_loss']:.6f}, "
                      f"worst leaf {max(r['errs'].values()):.3g}" for r in ranks))
    print(f"[14d] {max(r['ms'] for r in ranks):.1f} ms a value-and-grad on the slowest "
          f"stage (median of calls 2-3; the first {max(r['first_ms'] for r in ranks):.1f}"
          f" ms) against {ranks[0]['ref_ms']:.1f} ms for one rank's unsharded one (its "
          f"second call); kernel 1 {ranks[0]['k1'][0]} a call a stage ({ranks[0]['ticks']} "
          f"ticks x {ranks[0]['per_stage']} layers); peak memory per rank "
          f"{[round(r['peak_gb'], 3) for r in ranks]} GB; {time.monotonic() - t0:.1f} s "
          f"({name}; both stages on one card over gloo: no interconnect measured)")



# ---------------------------------------------------------------------------
# phase 15: the testing/ twin (local_stack) driven by scripts/loadgen.py,
# and the decode launch reports
# ---------------------------------------------------------------------------

#: The twin's command line on the card (its engine defaults otherwise).
TWIN_ARGS = ("--model", MODEL, "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ))
TWIN_READY_S = 600.0
TWIN_LOADGEN_S = 600.0
TWIN_LOG = "build/chip_smoke_twin.log"
#: The decode launch reports of phases 3, 6a, 6b and 6c's llama3-8b
#: engines, by (KV form, fused): (report, the gauge their warmup set).
LAUNCH_REPORTS = {}
#: The reference's cuts of the decode layer body, fused against unfused
#: (tests/test_fused_decode_layer.py): by KV form.
FUSED_CUTS = {"int8": 0.40, "int4": 0.40, None: 0.30}


async def engine_report(engine) -> dict:
    """A started engine's decode launch report (run on its executor)."""
    return await asyncio.get_running_loop().run_in_executor(
        None, engine.decode_launch_report)


async def with_report(phase, engine) -> dict:
    """``phase(engine)``, then the engine's decode launch report and the
    gauge its warmup published, kept in ``LAUNCH_REPORTS``."""
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    out = await phase(engine)
    gauge = global_metrics.gauge("engine_decode_kernels_per_step")
    LAUNCH_REPORTS[(engine_form(engine), engine.mcfg.fused_decode_layer)] = (
        await engine_report(engine), gauge)
    return out


def check_launch_reports(name: str) -> None:
    """15c: the reports of the llama3-8b engines of phases 3 and 6 — one
    hand-written kernel per layer-step on the kernel-2 and the fused
    paths, each gauge the report's ``layer_body_major``, and the fused
    layer body cut against the unfused one at the reference's
    thresholds."""
    for (form, fused), (report, gauge) in sorted(LAUNCH_REPORTS.items(),
                                                 key=str):
        print(f"[15c] {MODEL} kv {form} fused {fused}: {report}; "
              f"engine_decode_kernels_per_step {gauge:.0f} ({name})")
        if report["layer_body_kernels"] != 1:
            raise AssertionError(f"kv {form} fused {fused}: "
                                 f"{report['layer_body_kernels']} kernels a layer-step")
        if gauge != report["layer_body_major"]:
            raise AssertionError(f"kv {form} fused {fused}: gauge {gauge} != "
                                 f"report {report['layer_body_major']}")
    for form, want in FUSED_CUTS.items():
        fused = LAUNCH_REPORTS[(form, True)][0]["layer_body_ops"]
        unfused = LAUNCH_REPORTS[(form, False)][0]["layer_body_ops"]
        cut = 1 - fused / unfused
        print(f"[15c] kv {form}: layer body {fused} ops fused vs {unfused} "
              f"unfused, cut {cut:.3f} (reference threshold {want:.2f})")
        if cut < want:
            raise AssertionError(f"kv {form}: fused cut {cut:.3f} < {want}")


def reports_on_both_devices(name: str) -> None:
    """15c: tiny's decode launch report on the card equals the CPU's, at
    phase 3's configuration and at 6a's."""
    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    vocab = get_config("tiny").vocab_size
    configs = {
        "3": EngineConfig(model="tiny", num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                          dtype="bfloat16"),
        "6a": cli._engine_config(cli.build_parser().parse_args([
            "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", "tiny",
            "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ), "--kv-quant",
            "int4", "--fused-decode-layer", "--ragged-prefill"])),
    }
    for tag, ecfg in configs.items():
        reports = {}
        for dev in (DEVICE, "cpu"):
            engine = InferenceEngine(engine_cfg=ecfg, device=dev,
                                     tokenizer=NumericTokenizer(vocab_size=vocab))

            async def run(engine=engine):
                await engine.start()
                try:
                    return await engine_report(engine)
                finally:
                    await engine.stop()

            reports[dev] = asyncio.run(run())
        print(f"[15c] tiny at phase {tag}'s configuration: card {reports[DEVICE]}, "
              f"CPU {reports['cpu']} ({name})")
        if reports[DEVICE] != reports["cpu"]:
            raise AssertionError(f"phase {tag}'s configuration: the card's report "
                                 f"{reports[DEVICE]} != the CPU's {reports['cpu']}")


class TwinStack:
    """``python -m p2p_llm_tunnel_tpu_torch.testing.local_stack`` with
    ``TWIN_ARGS`` + ``flags`` as a child process on the card (its logs in
    ``TWIN_LOG``); ``with`` yields its port once it printed the readiness
    line, then SIGTERMs it and requires exit 0.  The child is killed on
    any failure: no process outlives the phase."""

    def __init__(self, *flags):
        self.cmd = [sys.executable, "-m", "p2p_llm_tunnel_tpu_torch.testing.local_stack",
                    "--port", "0", "--device", DEVICE, *TWIN_ARGS, *flags]

    def log_tail(self) -> str:
        with open(TWIN_LOG) as f:
            return f.read()[-4000:]

    def __enter__(self) -> int:
        import os
        import select

        os.makedirs(os.path.dirname(TWIN_LOG), exist_ok=True)
        with open(TWIN_LOG, "w") as log:
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE, stderr=log,
                                         text=True)
        t0, deadline = time.monotonic(), time.monotonic() + TWIN_READY_S
        try:
            while time.monotonic() < deadline:
                ready, _, _ = select.select([self.proc.stdout], [], [],
                                            max(0.1, deadline - time.monotonic()))
                line = self.proc.stdout.readline() if ready else ""
                if not line:
                    break
                if line.startswith("LOADGEN_STACK_PORT="):
                    self.ready_s = time.monotonic() - t0
                    return int(line.strip().split("=", 1)[1])
            raise AssertionError(f"twin {self.cmd[3:]} printed no readiness line "
                                 f"(exit {self.proc.poll()}):\n{self.log_tail()}")
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.proc.stdout.close()

    def __exit__(self, exc_type, *exc):
        import signal

        if exc_type is not None:
            self.kill()
            return False
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(120)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError("twin did not exit within 120 s of SIGTERM") from None
        self.proc.stdout.close()
        if rc != 0:
            raise AssertionError(f"twin exited {rc} on SIGTERM:\n{self.log_tail()}")
        return False


def twin_get(port: int, path: str) -> str:
    """GET ``path`` from the twin's listener (loopback)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def metric(text: str, name: str) -> float:
    """One unlabelled sample of a Prometheus text page."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not on the metrics page")


def run_loadgen(port: int, requests: int, *flags) -> dict:
    """``scripts/loadgen.py --port P --json ...`` against the twin: exit 0
    (no stuck stream, no leaked slot, page or transfer in its /healthz
    check) and every stream ok; its report."""
    cmd = [sys.executable, "scripts/loadgen.py", "--port", str(port), "--json", *flags]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=TWIN_LOADGEN_S)
    if out.returncode != 0:
        raise AssertionError(f"loadgen {flags} exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}\n{out.stdout[-3000:]}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    ok = sum(t["ok"] for t in report["tenants"])
    if ok != requests or sum(t["requests"] for t in report["tenants"]) != requests:
        raise AssertionError(f"loadgen {flags}: {ok} of {requests} streams ok: "
                             f"{report['tenants']}")
    return report


def print_loadgen(tag: str, report: dict, twin: TwinStack, name: str) -> None:
    for t in report["tenants"]:
        print(f"{tag} loadgen {t['tenant']}: {t['ok']}/{t['requests']} ok, "
              f"{t['tokens']} content tokens in {report['wall_s']} s = "
              f"{t['tokens'] / report['wall_s']:.1f} tok/s, TTFT p50 "
              f"{t['ttft_p50_ms']} ms, p99 {t['ttft_p99_ms']} ms; twin ready in "
              f"{twin.ready_s:.1f} s ({name})")


def twin_phase(name: str) -> None:
    """Phase 15: (a) the twin on the card at llama3-8b's widths and depth,
    a herd of 32 clients x 2 requests of 64 tokens from loadgen, its
    /healthz gauge against the report of an engine of the same
    configuration; (b) the same twin with ``--disagg`` (two engines on the
    card) under loadgen ``--turns 2``, KV pages shipped; (c) the report of
    tiny on the card against the CPU's."""
    import gc

    import torch

    from p2p_llm_tunnel_tpu_torch.testing import local_stack

    gc.collect()
    torch.cuda.empty_cache()
    # The engine the twin builds, here: its decode launch report.
    ref = local_stack._engine(local_stack.build_parser().parse_args(
        ["--device", DEVICE, *TWIN_ARGS]))

    async def report_of(engine):
        await engine.start()
        try:
            return await engine_report(engine)
        finally:
            await engine.stop()

    want = asyncio.run(report_of(ref))
    free_engine(ref)
    del ref
    print(f"[15a] the twin's configuration ({' '.join(TWIN_ARGS)}): {want}")
    twin = TwinStack()
    with twin as port:
        report = run_loadgen(port, 64, "--tenant", "herd:32:2", "--max-tokens", "64")
        healthz = json.loads(twin_get(port, "/healthz"))
    print_loadgen("[15a]", report, twin, name)
    per_step = healthz["decode_kernels_per_step"]
    print(f"[15a] /healthz decode_kernels_per_step {per_step}, warmup_compile_s "
          f"{healthz['warmup_compile_s']}; SIGTERM: exit 0")
    if not 0 < per_step == want["layer_body_major"]:
        raise AssertionError(f"/healthz decode_kernels_per_step {per_step} != the "
                             f"report's {want['layer_body_major']}")
    if not healthz["warmup_compile_s"] > 0:
        raise AssertionError(f"warmup_compile_s {healthz['warmup_compile_s']}")
    twin = TwinStack("--disagg")
    with twin as port:
        report = run_loadgen(port, 16, "--tenant", "conv:8", "--turns", "2",
                             "--max-tokens", "64")
        page = twin_get(port, "/metrics")
    print_loadgen("[15b] --disagg", report, twin, name)
    shipped = metric(page, "engine_pages_shipped_total")
    print(f"[15b] /metrics: {shipped:.0f} KV pages shipped, "
          f"{metric(page, 'engine_pages_spliced_total'):.0f} spliced; loadgen's "
          f"disagg row {report['disagg']}; SIGTERM: exit 0 ({name})")
    if shipped < 1:
        raise AssertionError("the disaggregated twin shipped no KV page")
    reports_on_both_devices(name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 5, 6a, 7 and 8a, profile each engine "
                         "with every slot busy (device busy share, time by "
                         "kernel) and count the CUDA launches of one decode "
                         "step (phase 7: one verify burst)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks); "
                         "prints no result line")
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then phase 11 alone (tensor parallelism, "
                         "SPMD ranks, replicas); prints no result line")
    ap.add_argument("--sp-only", action="store_true",
                    help="build, then phase 12 alone (sequence parallelism, "
                         "ring and Ulysses); prints no result line")
    ap.add_argument("--ep-only", action="store_true",
                    help="build, then phase 13 alone (expert parallelism and "
                         "--dp-dcn, ranks on the card); prints no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then phase 14 alone (training: kernel 1's "
                         "gradient, llama3.2-1b AdamW steps on one card, dp 2 x "
                         "tp 2 and pp 2 ranks on the card); prints no result line")
    ap.add_argument("--twins-only", action="store_true",
                    help="build, then phase 15 alone (the testing/ twin "
                         "driven by scripts/loadgen.py, plain and --disagg, "
                         "and tiny's launch report on the card against the "
                         "CPU's); prints no result line")
    ap.add_argument("--ep-nccl", action="store_true",
                    help=f"needs {EP_NCCL} cards: build, then phase 13e alone "
                         "(mixtral-8x7b at full depth, ep over NCCL, a card a "
                         "rank); prints no result line")
    ap.add_argument("--sp-nccl", action="store_true",
                    help=f"needs {SP_NCCL} cards: build, then phase 12e alone "
                         "(sp over NCCL, a card a rank: each exchange against "
                         "the library's collective, the prefill against one "
                         "rank's); prints no result line")
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
    count_model_calls()
    if args.tp_only:
        t0 = time.monotonic()
        tp_phase(name, lambda counts: None)
        replica_phase(name, lambda counts: None)
        print(f"[11] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.sp_only:
        t0 = time.monotonic()
        sp_phase(name, lambda counts: None)
        print(f"[12] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.sp_nccl:
        t0 = time.monotonic()
        sp_nccl_phase(name)
        print(f"[12e] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.ep_only:
        t0 = time.monotonic()
        ep_phase(name, lambda counts: None)
        print(f"[13] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.train_only:
        t0 = time.monotonic()
        train_phase(name, lambda counts: None)
        print(f"[14] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.twins_only:
        t0 = time.monotonic()
        twin_phase(name)
        print(f"[15] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0
    if args.ep_nccl:
        t0 = time.monotonic()
        ep_nccl_phase(name)
        print(f"[13e] phase {time.monotonic() - t0:.1f} s ({name})")
        return 0

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
            served = await with_report(
                lambda e: serve_phase(e, N_REQUESTS, MAX_TOKENS), engine)
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
    # Kernel 7 against its plain version inside the model: the same bf16
    # weights quantized on the card, raw cache, kernels 1 and 2 on both paths.
    from p2p_llm_tunnel_tpu_torch.models import quant as tq

    for wmode in ("int8", "w8a8", "int4"):
        qparams = (tq.quantize_params_int4(engine.params, 128) if wmode == "int4"
                   else tq.quantize_params(engine.params))
        lg = logits_phase(cfg, qparams, act_quant=wmode == "w8a8")
        print(f"[logits] weights {wmode} (kernel 7{' g128' if wmode == 'int4' else ''}"
              f"), raw cache: prefill + {lg['rows'] - 1} teacher-forced decode "
              f"steps: max |kernel - plain| {lg['max_abs_diff']:.4g} (limit "
              f"{lg['limit']:.4g} = 5% of max |logit| {lg['logit_scale']:.4g}), "
              f"argmax agreement {lg['argmax_agree']:.2f}")
        del qparams
        torch.cuda.empty_cache()
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
    t_ready, mux = run_engine(mux_engine, mux_embed_phase, args.profile)
    print_mux("[mux]", mux_engine, mux, t_ready, name)
    add_launches(mux["launches"])
    # [9a] embeddings through the tunnel on the same engine.
    print_embed(mux["embed"], name)
    add_launches(mux["embed"]["launches"])
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
    t_ready, m6a = run_engine(e6a, lambda e: with_report(mux_phase, e), args.profile)
    print_mux("[6a]", e6a, m6a, t_ready, name)
    if any(m6a["launches"][row_name("flash_decode_attention", f)] for f in FORMS):
        raise AssertionError("kernel 2 launched on the fused engine")
    add_launches(m6a["launches"])
    free_engine(e6a)
    del e6a
    # 6b: int8 on the defaults (unfused: kernel 2's int8 form).
    e6b = cli_engine(params, cfg, "--kv-quant", "int8")
    t_ready, m6b = run_engine(e6b, lambda e: with_report(mux_phase, e))
    print_mux("[6b]", e6b, m6b, t_ready, name)
    add_launches(m6b["launches"])
    free_engine(e6b)
    del e6b
    # 6c: the remaining (kernel, KV form) pairs, a few short streams each.
    for flags in (("--kv-quant", "int8", "--fused-decode-layer", "--ragged-prefill"),
                  ("--fused-decode-layer",),
                  ("--kv-quant", "int4", "--no-mux")):
        e6c = cli_engine(params, cfg, *flags)
        t_ready, short = run_engine(
            e6c, lambda e: with_report(lambda x: serve_phase(x, 4, 16), e))
        nonzero = {k: v for k, v in short["launches"].items() if v}
        print(f"[6c] {' '.join(flags)}: ready in {t_ready:.1f} s; 4 streams x "
              f"16 tokens finished; {short['waves']} prefill waves, "
              f"{short['steps']} decode steps, {short['dispatches']} ragged "
              f"dispatches, launch counts {nonzero}")
        add_launches(short["launches"])
        free_engine(e6c)
        del e6c
    # 15c: the decode launch reports of phases 3 and 6's engines.
    check_launch_reports(name)

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
    # Phase 10: the spill tier, pool snapshots and KV_PAGES disaggregation
    # on phase 5's weights and conversations (runs here, while the weights
    # live).
    t0 = time.monotonic()
    spill_phases(params, cfg, name, mux, m6a, add_launches)
    print(f"[10] phase {time.monotonic() - t0:.1f} s ({name})")
    del params
    torch.cuda.empty_cache()

    # Phase 8: weight quantization — llama3-8b at full width on random
    # weights drawn directly quantized from seed 0 (no bf16 tree), kernel 7
    # on every projection and the head (225 launches a model call).
    from p2p_llm_tunnel_tpu_torch.models.quant import weight_bytes

    # 8a: 6a's engine with --quant int4 g128, the conversations of phase 5.
    int4_flags = ("--kv-quant", "int4", "--fused-decode-layer", "--ragged-prefill",
                  "--quant", "int4", "--quant-group-size", "128")
    t0 = time.monotonic()
    e8a = cli_engine(None, cfg, *int4_flags)
    t_init = time.monotonic() - t0
    t_ready, m8a = run_engine(e8a, mux_phase, args.profile)
    print(f"[8a] weights {weight_bytes(e8a.params) / 1e9:.3f} GB on the card "
          f"(init {t_init:.1f} s); stream bound {stream_bound_ms(e8a):.4f} ms a step")
    print_mux("[8a]", e8a, m8a, t_ready, name)
    print_quant_launches("[8a]", m8a, e8a)
    k7 = k7_call_ms(e8a)
    per_call = 7 * e8a.mcfg.n_layers + 1
    if k7["decode_products"] != per_call or k7["prefill_products"] != per_call:
        raise AssertionError(f"[8a] kernel 7 products per call {k7}, not {per_call}")
    print(f"[8a] kernel 7 device {k7['decode_ms']:.4f} ms per decode step (17 rows) "
          f"and {k7['prefill_ms']:.4f} ms per prefill call (a ragged dispatch of "
          f"{RAGGED_TOT} tokens), {per_call} products each; the decode step's "
          f"weight-stream bound {stream_bound_ms(e8a):.4f} ms ({name})")
    add_launches(m8a["launches"])
    int4_params = e8a.params
    free_engine(e8a)
    del e8a
    # 8c (spec): 8a with prompt-lookup speculation, same weights.
    e8s = cli_engine(int4_params, cfg, *int4_flags, "--spec-ngram", "3", "--spec-k",
                     "4", "--spec-k-max", "8")
    t_ready, m8s = run_engine(e8s, mux_phase)
    if m8s["spec"] <= 0:
        raise AssertionError("phase 8c ran no verify burst")
    print_mux("[8c spec]", e8s, m8s, t_ready, name)
    print_quant_launches("[8c spec]", m8s, e8s)
    add_launches(m8s["launches"])
    free_engine(e8s)
    del e8s, int4_params
    torch.cuda.empty_cache()
    # 8b: serve defaults + ragged with --quant int8 --prefill-act-quant:
    # prefill W8A8, decode weight-only.
    e8b = cli_engine(None, cfg, "--ragged-prefill", "--quant", "int8",
                     "--prefill-act-quant")
    t_ready, m8b = run_engine(e8b, mux_phase)
    print_mux("[8b]", e8b, m8b, t_ready, name)
    print_quant_launches("[8b]", m8b, e8b)
    add_launches(m8b["launches"])
    int8_params = e8b.params
    free_engine(e8b)
    del e8b
    # 8c: --quant w8a8 on the same int8 weights, a short serve.
    e8c = cli_engine(int8_params, cfg, "--quant", "w8a8")
    t_ready, short = run_engine(e8c, lambda e: serve_phase(e, 4, 16))
    print(f"[8c] --quant w8a8: ready in {t_ready:.1f} s; 4 streams x 16 tokens "
          f"finished, {short['tok_s']:.1f} tok/s ({name})")
    print_quant_launches("[8c]", short, e8c)
    add_launches(short["launches"])
    free_engine(e8c)
    del e8c, int8_params
    torch.cuda.empty_cache()
    # 8d: llama3-70b at full width and depth, --quant int4 and --kv-quant
    # int8: the configuration bf16 weights (~141 GB) cannot hold on one card.
    cfg70 = get_config("llama3-70b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    e8d = cli_engine(None, cfg70, "--quant", "int4", "--kv-quant", "int8",
                     model="llama3-70b")
    t_init = time.monotonic() - t0
    t_ready, short = run_engine(e8d, lambda e: serve_phase(e, 4, 16))
    print(f"[8d] llama3-70b ({cfg70.n_layers} layers, dim {cfg70.dim}) --quant int4 "
          f"g128 --kv-quant int8: weights {weight_bytes(e8d.params) / 1e9:.3f} GB on "
          f"the card (init {t_init:.1f} s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; ready in {t_ready:.1f} s; "
          f"4 streams x 16 tokens finished, {short['steps']} decode steps, "
          f"{short['tok_s']:.1f} tok/s ({name}); stream bound "
          f"{stream_bound_ms(e8d):.4f} ms a step")
    print_quant_launches("[8d]", short, e8d)
    add_launches(short["launches"])
    free_engine(e8d)
    del e8d
    # 8e: tiny-qwen --quant int4: its untied head of 259 columns through
    # kernel 7's padded rows.
    cfg_tq = get_config("tiny-qwen")
    e8e = cli_engine(None, cfg_tq, "--quant", "int4", model="tiny-qwen")
    head = e8e.params["lm_head"]
    t_ready, short = run_engine(e8e, lambda e: serve_phase(e, 4, 16))
    print(f"[8e] tiny-qwen --quant int4 g128 (head {tuple(head.q.shape)} bytes in rows "
          f"of {head.q.stride(0)}): ready in {t_ready:.1f} s; 4 streams x 16 tokens "
          f"finished through the tunnel, {short['steps']} decode steps ({name})")
    print_quant_launches("[8e]", short, e8e)
    add_launches(short["launches"])
    free_engine(e8e)
    del e8e

    # Phase 9b: mixture-of-experts at mixtral-8x7b's widths (depth cut).
    t0 = time.monotonic()
    moe_phase(name, add_launches)
    print(f"[9b] phase {time.monotonic() - t0:.1f} s ({name})")
    # Phase 9c: HF conversion -> save_checkpoint -> --ckpt (depth cut).
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    ckpt_phase(name, add_launches)
    print(f"[9c] phase {time.monotonic() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({name})")
    # Phase 11: --tp 2 (two SPMD ranks on the card), --replicas 2.
    t0 = time.monotonic()
    tp_phase(name, add_launches)
    replica_phase(name, add_launches)
    print(f"[11] phase {time.monotonic() - t0:.1f} s ({name})")
    # Phase 12: --sp 2 (ring and Ulysses) and tp 2 x sp 2, ranks on the card.
    t0 = time.monotonic()
    sp_phase(name, add_launches)
    print(f"[12] phase {time.monotonic() - t0:.1f} s ({name})")
    # Phase 13: --ep 2 (mixtral widths) and --dp-dcn 2 (llama3-8b), ranks on
    # the card.
    t0 = time.monotonic()
    ep_phase(name, add_launches)
    print(f"[13] phase {time.monotonic() - t0:.1f} s ({name})")
    # Phase 14: training — kernel 1 under autograd, llama3.2-1b on one card,
    # dp 2 x tp 2 and pp 2 ranks on the card.
    t0 = time.monotonic()
    train_phase(name, add_launches)
    print(f"[14] phase {time.monotonic() - t0:.1f} s ({name})")
    # Phase 15: the testing/ twin on the card, driven by scripts/loadgen.py.
    t0 = time.monotonic()
    twin_phase(name)
    print(f"[15] phase {time.monotonic() - t0:.1f} s ({name})")

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
        "quant_matmul": (
            "p2p_llm_tunnel_tpu_torch/csrc/quant_matmul.cu",
            "p2p_llm_tunnel_tpu/models/quant.py:298"),
    }
    table = []
    for rname, cases in rows.items():
        kname = max((k for k in source if rname == k or rname.startswith(k + "_")),
                    key=len)
        tag = JSON_SHAPES.get(kname)
        pick = next((r for r in cases if tag and f" {tag} " in f" {r['shape']} "),
                    cases[0])
        extra = {}
        if kname == "quant_matmul":
            extra["note"] = ("no pallas_call: XLA fuses the dequant into mm's "
                             "operand on the TPU (models/quant.py:298, :336)")
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
