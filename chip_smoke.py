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
   logits' difference;
5. serve the same weights again on the serve CLI's default engine (mux,
   prefix pool, conversation cache) with ``--ragged-prefill``: 8
   two-turn conversations sharing a ~300-token system prompt, every second
   turn resending its first turn and the answer; check every stream
   finished, the prefix / dedup / conversation counters rose, each second
   turn's pool hit reached into its first turn's answer, and the ragged
   kernel launched exactly 32 times per ragged dispatch.

The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  ``--profile`` adds a
torch.profiler window over each engine with every slot busy (device busy
share, device time by kernel) after phases 3 and 5.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

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
               "ragged_prefill_attention": "TOT1024"}
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


def timed_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = ATOL + RTOL * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    if (err > limit).any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max |err| "
            f"{err.max().item():.4g} (tolerance {ATOL} + {RTOL}*|ref|)"
        )
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def prefill_case(b, t, h, kh, d, lengths, window=None, softcap=None, seed=0):
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
    row = dict(
        shape=f"B{b} T{t} H{h} K{kh} D{d}" + (f" window{window}" if window else "")
        + (f" softcap{softcap}" if softcap else "")
        + ("" if min(lengths) == t else " padded"),
        max_abs_err=err,
        ms=timed_ms(lambda: fa.flash_causal_attention(q, k, v, valid, **kw)),
        plain_ms=timed_ms(lambda: fa.plain(q, k, v, valid, **kw), iters=5),
    )
    library_ms = None
    if softcap is None:
        qh = q.transpose(1, 2)
        kx = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
        vx = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
        am = mask[:, None]
        library_ms = timed_ms(
            lambda: F.scaled_dot_product_attention(qh, kx, vx, attn_mask=am))
    row["library_ms"] = library_ms
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


def decode_case(b, s, h, kh, d, positions, s_max=MAX_SEQ, seed=0):
    import torch
    import torch.nn.functional as F

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    # Windows [:, :S] of a [B, S_max, K, D] cache, as the model passes them.
    kc = torch.randn((b, s_max, kh, d), generator=g, device="cuda").bfloat16()
    vc = torch.randn((b, s_max, kh, d), generator=g, device="cuda").bfloat16()
    k_view, v_view = kc[:, :s], vc[:, :s]
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    got = da.flash_decode_attention(q, k_view, v_view, pos)
    want = da.plain(q, k_view, v_view, pos)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode_attention S={s}", got, want)

    live = [min(p, s - 1) + 1 for p in positions]  # keys each slot attends
    nbytes = 2 * 2 * sum(live) * kh * d + 2 * 2 * b * h * d + 4 * b
    flops = 4 * d * h * sum(live)
    row = dict(
        shape=f"B{b} S{s} H{h} K{kh} D{d} parked{sum(p >= s for p in positions)}",
        max_abs_err=err,
        ms=timed_ms(lambda: da.flash_decode_attention(q, k_view, v_view, pos),
                    iters=50),
        plain_ms=timed_ms(lambda: da.plain(q, k_view, v_view, pos)),
    )
    qh = q.transpose(1, 2)
    kx = k_view.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vx = v_view.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    am = (torch.arange(s, device="cuda")[None, :] <= pos[:, None].long())
    am = am[:, None, None, :]
    row["library_ms"] = timed_ms(
        lambda: F.scaled_dot_product_attention(qh, kx, vx, attn_mask=am),
        iters=50)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
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

    errs = {"flash_causal_attention": 0.0, "flash_decode_attention": 0.0}
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
    return errs


#: The ragged kernel's serving group: 8 rows of (history, tail) with
#: histories {0, 16, 128, 368, 512} and tails that end mid-block, flat
#: bucket TOT 1024 = prefill_rows 8 x prefill_chunk 128 (the mux default).
RAGGED_ROWS = [(0, 100), (16, 37), (128, 128), (368, 77), (512, 5), (0, 120),
               (128, 63), (368, 99)]
RAGGED_TOT = 1024


def ragged_group(h, kh, d, rows, tot, s=MAX_SEQ, slots=NUM_SLOTS + 1,
                 window=None, softcap=None, seed=0, layers=2):
    """Run the ragged kernel and its plain version on copies of the same
    random cache; check the real rows' attention and every non-scratch
    cache row.  Returns (kernel, plain, inputs) for timing."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa

    entries = [(i, st, ln) for i, (st, ln) in enumerate(rows)]
    slot_of, start_of, qoff_of, _qlen, base_of, offs = pa.plan_ragged_group(
        entries, 16, tot, scratch_slot=slots - 1)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    q, kn, vn = rnd(tot, h, d), rnd(tot, kh, d), rnd(tot, kh, d)
    kc, vc = rnd(layers, slots, s, kh, d), rnd(layers, slots, s, kh, d)
    descs = [torch.tensor(x, device="cuda") for x in (slot_of, start_of, qoff_of, base_of)]
    kw = dict(block_q=16, rope_theta=500000.0, window=window, softcap=softcap)
    layer = layers - 1
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = pa.ragged_prefill_attention(q, kn, vn, k1, v1, *descs, layer, **kw)
    want = pa.plain(q, kn, vn, k2, v2, *descs, layer, **kw)
    torch.cuda.synchronize()
    name = f"ragged_prefill_attention H{h} K{kh} D{d} window {window} softcap {softcap}"
    real = torch.cat([torch.arange(o, o + ln, device="cuda")
                      for (_, _, ln), o in zip(entries, offs)])
    err = check_close(name, got[real], want[real])
    cache_err = max(check_close(name + " cache", a[:, :-1], b[:, :-1])
                    for a, b in ((k1, k2), (v1, v2)))
    return dict(entries=entries, offs=offs, err=max(err, cache_err),
                run=lambda: pa.ragged_prefill_attention(q, kn, vn, k1, v1, *descs, layer, **kw),
                run_plain=lambda: pa.plain(q, kn, vn, k2, v2, *descs, layer, **kw),
                q=q, k1=k1, v1=v1, layer=layer)


def ragged_case(h, kh, d):
    """The serving group shape, timed: kernel, plain version, and an
    attention-only yardstick — scaled_dot_product_attention with an
    explicit boolean mask over the same rows padded to [rows, H, tail,
    start + tail] (it does no rope and no append; the port never calls
    it)."""
    import torch
    import torch.nn.functional as F

    c = ragged_group(h, kh, d, RAGGED_ROWS, RAGGED_TOT)
    rows = len(RAGGED_ROWS)
    t_max = max(ln for _, ln in RAGGED_ROWS)
    s_max = max(st + ln for st, ln in RAGGED_ROWS)
    qp = torch.zeros((rows, h, t_max, d), dtype=torch.bfloat16, device="cuda")
    kp = torch.zeros((rows, h, s_max, d), dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    mask = torch.zeros((rows, 1, t_max, s_max), dtype=torch.bool, device="cuda")
    for r, ((slot, st, ln), off) in enumerate(zip(c["entries"], c["offs"])):
        qp[r, :, :ln] = c["q"][off:off + ln].transpose(0, 1)
        for dst, src in ((kp, c["k1"]), (vp, c["v1"])):
            dst[r, :, :st + ln] = src[c["layer"], slot, :st + ln].transpose(
                0, 1).repeat_interleave(h // kh, dim=0)
        i = torch.arange(ln, device="cuda")[:, None]
        j = torch.arange(s_max, device="cuda")[None, :]
        mask[r, 0, :ln] = j <= st + i
    real = sum(ln for _, ln in RAGGED_ROWS)
    pairs = sum(st * ln + ln * (ln + 1) // 2 for st, ln in RAGGED_ROWS)
    hist = sum(st for st, _ in RAGGED_ROWS)
    # q + k_new + v_new + out + appended K/V, each real row once, plus the
    # history each row reads; bf16.
    nbytes = 2 * (real * (2 * h + 4 * kh) * d + 2 * hist * kh * d)
    row = dict(
        shape=f"rows{rows} TOT{RAGGED_TOT} BQ16 H{h} K{kh} D{d} "
              f"hist{sorted({st for st, _ in RAGGED_ROWS})}",
        max_abs_err=c["err"],
        ms=timed_ms(c["run"]),
        plain_ms=timed_ms(c["run_plain"], iters=5),
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qp, kp, vp, attn_mask=mask)),
    )
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * h * d * pairs)
    return row


def ragged_preset_checks() -> float:
    """Untimed: the ragged kernel's other head-dim and grouping instances
    at the presets' head geometry (gemma2-2b with window 64 + softcap 50,
    llama3.2-1b D 64, llama3-70b G 8, qwen2-7b G 7, tiny-gemma D 16 with
    window 8 + softcap 50).  Returns the max |kernel - plain|."""
    worst = 0.0
    rows = [(0, 40), (32, 17), (96, 64)]
    for preset, h, kh, d, window, softcap in (
        ("gemma2-2b", 8, 4, 256, 64, 50.0),
        ("llama3.2-1b", 32, 8, 64, None, None),
        ("llama3-70b", 64, 8, 128, None, None),
        ("qwen2-7b", 28, 4, 128, None, None),
        ("tiny-gemma", 4, 2, 16, 8, 50.0),
    ):
        c = ragged_group(h, kh, d, rows, 160, s=256, slots=5, window=window,
                         softcap=softcap, seed=4, layers=1)
        print(f"[kernels] ragged {preset} heads {h}/{kh} D {d} window "
              f"{window} softcap {softcap}: max|err| {c['err']:.3e}")
        worst = max(worst, c["err"])
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
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = {"flash_causal_attention": [], "flash_decode_attention": []}
    for t in (128, 200, 256, 512):
        rows["flash_causal_attention"].append(prefill_case(8, t, h, kh, d, [t] * 8))
    rows["flash_causal_attention"].append(prefill_case(
        8, 512, h, kh, d, [512] * 8, window=128, softcap=30.0, seed=1))
    rows["flash_causal_attention"].append(prefill_case(
        8, 512, h, kh, d, [512, 300, 17, 128, 129, 1, 450, 64], seed=2))
    b = NUM_SLOTS + 1  # the engine's rows: every slot plus the scratch row
    for s in (128, 256, 512, 1024):
        rows["flash_decode_attention"].append(
            decode_case(b, s, h, kh, d, decode_positions(b, s)))
    rows["ragged_prefill_attention"] = [ragged_case(h, kh, d)]
    for name, cases in rows.items():
        print(f"[kernels] {name} (bf16 in, fp32 math; tolerance "
              f"{ATOL} + {RTOL}*|ref|)")
        for r in cases:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {r['shape']:<40} max|err| {r['max_abs_err']:.3e}  "
                  f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"library {lib} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    return rows


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
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import flash_decode_attention
    from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

    waves, steps = [0], [0]
    dispatch_prefill, decode_fn = engine._dispatch_prefill_batch, engine._decode_fn

    def counted_prefill(*a, **kw):
        waves[0] += 1
        return dispatch_prefill(*a, **kw)

    def counted_decode(*a, **kw):
        steps[0] += a[5]  # (ov_mask, ov_tok, ov_pos, samp, view, steps)
        return decode_fn(*a, **kw)

    engine._dispatch_prefill_batch = counted_prefill
    engine._decode_fn = counted_decode

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
        flash_causal_attention.launches = 0
        flash_decode_attention.launches = 0
        t0 = time.monotonic()
        results = await asyncio.gather(*[
            _stream(base, i, max_tokens, p) for i, p in enumerate(prompts)
        ])
        wall = time.monotonic() - t0
        launches = {"flash_causal_attention": flash_causal_attention.launches,
                    "flash_decode_attention": flash_decode_attention.launches}
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        serve_ch.close()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        engine._dispatch_prefill_batch = dispatch_prefill
        engine._decode_fn = decode_fn
    for r in results:
        if r["tokens"] != max_tokens or r["finish"] != "length":
            raise AssertionError(f"stream ended early: {r}")
    n_layers = engine.mcfg.n_layers
    if engine.device.type == "cuda":
        if (launches["flash_causal_attention"] != n_layers * waves[0]
                or waves[0] == 0):
            raise AssertionError(
                f"prefill kernel launches {launches['flash_causal_attention']}"
                f" != {n_layers} x {waves[0]} prefill waves")
        if (launches["flash_decode_attention"] != n_layers * steps[0]
                or steps[0] == 0):
            raise AssertionError(
                f"decode kernel launches {launches['flash_decode_attention']}"
                f" != {n_layers} x {steps[0]} decode steps")
    ttfts = [r["ttft"] for r in results]
    return dict(results=results, wall=wall, launches=launches,
                waves=waves[0], steps=steps[0],
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

    steps = [0]
    decode_fn = engine._decode_fn

    def counted_decode(*a, **kw):
        steps[0] += a[5]
        return decode_fn(*a, **kw)

    async def one(i):
        prompt = [(7 * i + j) % 250 + 1 for j in range(96 + 24 * i)]
        return sum([1 async for _ in engine.generate(
            prompt, max_new_tokens=max_tokens, stop_ids=())])

    engine._decode_fn = counted_decode
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

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:14]
    return dict(wall_s=wall, tokens=tokens, steps=steps[0],
                busy_ms=busy_ms, busy_share=busy_ms / (wall * 1e3),
                top=[(e.key[:70], e.count, dev_us(e) / 1e3) for e in top])


def print_profile(tag: str, pr: dict, name: str) -> None:
    import torch

    print(f"{tag} {NUM_SLOTS} streams x {MAX_TOKENS} tokens: "
          f"{pr['tokens']} tokens, {pr['steps']} decode steps in "
          f"{pr['wall_s']:.3f} s ({pr['tokens'] / pr['wall_s']:.1f} "
          f"tok/s, {pr['wall_s'] * 1e3 / max(pr['steps'], 1):.2f} ms "
          f"per step incl. prefill); device busy {pr['busy_ms']:.1f} ms "
          f"= {100 * pr['busy_share']:.1f}% of the window ({name}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for key, count, ms in pr["top"]:
        print(f"{tag}   {ms:9.2f} ms  {count:6d}x  {key}")


# ---------------------------------------------------------------------------
# phase 4: logits through the kernel path and the plain path
# ---------------------------------------------------------------------------

def logits_phase(cfg, params, prompt_len: int = 200, forced: int = 4) -> dict:
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tr
    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa

    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, 256, (1, prompt_len), generator=g, device=dev)
    forced_toks = torch.randint(0, 256, (forced,), generator=g, device=dev)

    def run():
        cache = tr.init_kv_cache(cfg, 1, 512, dtype=params["embed"].dtype,
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

    with torch.inference_mode():
        kernel = run()
        tr.flash_causal_attention, tr.flash_decode_attention = fa.plain, da.plain
        try:
            plain = run()
        finally:
            tr.flash_causal_attention = fa.flash_causal_attention
            tr.flash_decode_attention = da.flash_decode_attention
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
            f"kernel-path logits drift {diff:.4g} > {limit:.4g} from the plain path")
    return dict(max_abs_diff=diff, logit_scale=scale, limit=limit,
                argmax_agree=agree, rows=forced + 1)


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
    """8 two-turn conversations through the tunnel on the mux engine."""
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import flash_decode_attention
    from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
    from p2p_llm_tunnel_tpu_torch.ops.prefill_attention import ragged_prefill_attention
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    dispatches, steps, hist_of = [0], [0], {}
    ragged_rows, decode_fn, match = (engine._dispatch_ragged_rows,
                                     engine._decode_fn, engine._prefix.match)

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

    engine._dispatch_ragged_rows = counted_ragged
    engine._decode_fn = counted_decode
    engine._prefix.match = recorded_match
    counters = ("engine_prefix_hit_tokens_total",
                "engine_prefix_dedup_hits_total",
                "engine_conv_saved_pages_total", "engine_conv_hits_total")
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
        flash_causal_attention.launches = 0
        flash_decode_attention.launches = 0
        ragged_prefill_attention.launches = 0
        t0 = time.monotonic()
        one = await asyncio.gather(*[
            _conv_turn(base, p, TURN1_TOKENS, ndjson=i % 2 == 1)
            for i, p in enumerate(firsts)])
        seconds = [p + r["ids"] + list(b" And what happens next?")
                   for p, r in zip(firsts, one)]
        two = await asyncio.gather(*[
            _conv_turn(base, p, TURN2_TOKENS, ndjson=False) for p in seconds])
        wall = time.monotonic() - t0
        launches = {"flash_causal_attention": flash_causal_attention.launches,
                    "flash_decode_attention": flash_decode_attention.launches,
                    "ragged_prefill_attention": ragged_prefill_attention.launches}
        deltas = {c: global_metrics.counter(c) - before[c] for c in counters}
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        serve_ch.close()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        engine._dispatch_ragged_rows = ragged_rows
        engine._decode_fn = decode_fn
        engine._prefix.match = match
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
    n_layers = engine.mcfg.n_layers
    if (dispatches[0] == 0
            or launches["ragged_prefill_attention"] != n_layers * dispatches[0]):
        raise AssertionError(
            f"ragged kernel launches {launches['ragged_prefill_attention']} != "
            f"{n_layers} x {dispatches[0]} ragged dispatches")
    if launches["flash_decode_attention"] != n_layers * steps[0] or steps[0] == 0:
        raise AssertionError(
            f"decode kernel launches {launches['flash_decode_attention']} != "
            f"{n_layers} x {steps[0]} decode steps")
    if engine._page_reserved or engine._prefix.reserved_pages:
        raise AssertionError("pool pages still reserved after every stream ended")
    ttfts = [r["ttft"] for r in one + two]
    return dict(one=one, two=two, wall=wall, launches=launches,
                dispatches=dispatches[0], steps=steps[0], deltas=deltas,
                hists=[hist_of.get(tuple(p), 0) for p in seconds],
                sys_pages=sys_pages,
                tok_s=sum(len(r["ids"]) for r in one + two) / wall,
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                ttft_max_ms=max(ttfts) * 1e3,
                turn1_ttft_p50_ms=statistics.median(r["ttft"] for r in one) * 1e3,
                turn2_ttft_p50_ms=statistics.median(r["ttft"] for r in two) * 1e3)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3 and 5, profile each engine with "
                         "every slot busy (device busy share, time by kernel)")
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
    rows = kernel_phase(cfg)
    other_errs = preset_checks()
    other_errs["ragged_prefill_attention"] = ragged_preset_checks()

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
    launches = serve["launches"]
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
          f"{launches})")
    if "profile" in serve:
        print_profile("[profile]", serve["profile"], name)

    # Phase 4: kernel path vs plain path on the same weights.
    lg = logits_phase(cfg, engine.params)
    print(f"[logits] prefill + {lg['rows'] - 1} teacher-forced decode steps: "
          f"max |kernel - plain| {lg['max_abs_diff']:.4g} (limit "
          f"{lg['limit']:.4g} = 5% of max |logit| {lg['logit_scale']:.4g}), "
          f"argmax agreement {lg['argmax_agree']:.2f}")

    # Phase 5: the serve CLI's default engine + --ragged-prefill on the same
    # weights; the first engine's cache is freed before the second is built.
    from p2p_llm_tunnel_tpu_torch import cli

    params = engine.params
    engine.kv_cache = None
    del engine
    torch.cuda.empty_cache()
    mux_cfg = cli._engine_config(cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--room", "chip-smoke", "--model", MODEL,
        "--slots", str(NUM_SLOTS), "--max-seq", str(MAX_SEQ),
        "--ragged-prefill"]))
    t0 = time.monotonic()
    mux_engine = InferenceEngine(
        engine_cfg=mux_cfg, params=params,
        tokenizer=NumericTokenizer(vocab_size=cfg.vocab_size))
    if not (mux_engine.ecfg.mux and mux_engine.ecfg.prefix_cache
            and mux_engine.ecfg.conv_cache and mux_engine.ecfg.ragged_prefill):
        raise AssertionError(f"mux engine fenced: {mux_engine.config_fences}")

    async def drive_mux():
        await mux_engine.start()
        try:
            await mux_engine.warmup()
            t_ready = time.monotonic() - t0
            mux = await mux_phase(mux_engine)
            if args.profile:
                mux["profile"] = await profile_phase(
                    mux_engine, NUM_SLOTS, MAX_TOKENS)
            return t_ready, mux
        finally:
            await mux_engine.stop()

    t_ready, mux = asyncio.run(drive_mux())
    ec = mux_engine.ecfg
    print(f"[mux] {MODEL} bf16 serve-CLI defaults (mux {ec.mux}, prefix cache "
          f"{ec.prefix_cache}, conv cache {ec.conv_cache}, ragged "
          f"{ec.ragged_prefill}, prefill_chunk {ec.prefill_chunk}, ragged "
          f"TOT {mux_engine._ragged_tot}) ready in {t_ready:.1f} s; "
          f"{N_CONV} conversations x 2 turns ({TURN1_TOKENS} + {TURN2_TOKENS} "
          f"tokens), system prompt {len(SYSTEM_PROMPT)} tokens")
    for r in mux["one"] + mux["two"]:
        print(f"[mux]   {r['kind']:<6} tokens {len(r['ids'])} finish "
              f"{r['finish']} ttft {r['ttft'] * 1e3:.1f} ms total "
              f"{r['seconds']:.2f} s")
    print(f"[mux] counters {mux['deltas']}; turn-2 pool hits {mux['hists']} "
          f"tokens (system prompt pages {mux['sys_pages']} tokens)")
    print(f"[mux] ragged dispatches {mux['dispatches']}, decode steps "
          f"{mux['steps']}, launch counts {mux['launches']}")
    print(f"[mux] {mux['tok_s']:.1f} tok/s ({name}; both turns, client side "
          f"through the tunnel)")
    print(f"[mux] TTFT p50 {mux['ttft_p50_ms']:.1f} ms, max "
          f"{mux['ttft_max_ms']:.1f} ms (turn 1 p50 "
          f"{mux['turn1_ttft_p50_ms']:.1f} ms, turn 2 p50 "
          f"{mux['turn2_ttft_p50_ms']:.1f} ms; {name})")
    if "profile" in mux:
        print_profile("[profile mux]", mux["profile"], name)
    launches["ragged_prefill_attention"] = mux["launches"]["ragged_prefill_attention"]
    del mux_engine, params

    source = {
        "flash_causal_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/flash_causal_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_attention.py:136"),
        "flash_decode_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/flash_decode_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py:446"),
        "ragged_prefill_attention": (
            "p2p_llm_tunnel_tpu_torch/csrc/ragged_prefill_attention.cu",
            "p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py:563"),
    }
    table = []
    for kname, cases in rows.items():
        tag = JSON_SHAPES[kname]
        pick = next(r for r in cases if f" {tag} " in f" {r['shape']} ")
        table.append(dict(
            name=kname, route="cuda", source=source[kname][0],
            replaces=source[kname][1], launches=launches[kname],
            max_abs_err=max([r["max_abs_err"] for r in cases]
                            + [other_errs[kname]]),
            ms=pick["ms"], plain_ms=pick["plain_ms"],
            bound_ms=pick["bound_ms"], bound_by=pick["bound_by"],
            library_ms=pick["library_ms"], shape=pick["shape"],
        ))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
