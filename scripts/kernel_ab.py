#!/usr/bin/env python3
"""A/B of the port's kernels against an earlier source of each, on one
NVIDIA card, with ``chip_smoke.py``'s L2-cold harness: the prefill flash
kernel (kernel 1), the slot-decode kernel (kernel 2), the fused decode
layer (kernel 4) and the ragged prefill kernel (kernel 6).

    mkdir -p build/kernel_ab_parent
    for f in flash_decode_attention.cu ragged_prefill_attention.cu \\
             decode_tile.cuh kv_forms.cuh; do
      git show <commit>:p2p_llm_tunnel_tpu_torch/csrc/$f > build/kernel_ab_parent/$f
    done
    python3 scripts/kernel_ab.py --parent-src build/kernel_ab_parent --kernels 2,6

``--kernels`` names the kernels to compare (default ``1,4``); the
directory holds each one's earlier ``.cu`` and the headers it includes.
The earlier sources must export these C ABIs:
- kernel 1: ``flash_causal_attention_bf16(q, k, v, valid, out, B, T, H,
  KH, D, scale, softcap, window, stream)``;
- kernel 2: the single-block ``flash_decode_attention_launch(q, k, v,
  k_scale, v_scale, positions, out, B, S, H, KH, D, slot_stride,
  scale_slot_stride, form, scale, softcap, window, stream)`` (strides as
  64-bit integers);
- kernel 4: the single-block ``fused_decode_layer_launch(q, k_new, v_new,
  k_cache, v_cache, k_scale, v_scale, sin, cos, positions, out, B, S, H,
  KH, D, L, layer, view, form, scale, softcap, window, stream)``;
- kernel 6: ``ragged_prefill_attention_launch(q, k_new, v_new, k_cache,
  v_cache, k_scale, v_scale, sin, cos, slot_of, start_of, qoff_of,
  base_of, out, nqb, H, KH, D, BQ, B, S, layer, form, scale, softcap,
  window, stream)``, the current one.
They are built with the port's nvcc flags into ``build/kernel_ab/`` (one
nvcc process each, started together); the current sources through
``ops/kernel_build.py``.

Kernel 1 runs at llama3-8b's head geometry, B 8 and T 128/256/512/1024
(the plain loop's prefill waves), every row valid; kernel 2 in each KV
form at B 17 and view 512, and raw also at views 128, 256 and 1024, over
strided windows of a 1024-position cache; kernel 4 in each KV form at the
decode positions (B 17, view 512 over a 1024-position cache); kernel 6
in each KV form on ``chip_smoke.RAGGED_ROWS`` (8 rows, TOT 1024).  Both
kernels of a pair run on the same inputs — outputs within
``chip_smoke.ATOL``/``RTOL`` of each other, appended caches and scales
bit-exact (kernel 6 raw: within the tolerance) — then are timed in turns
(earlier, current, current, earlier), three runs of 20 or 50 launches
each (CUDA events), L2-cold: kernel 1 rotates over copies of its inputs,
kernels 2 and 4 the layer over a stacked cache, kernel 6 both, whose
bytes exceed ``chip_smoke.L2_COLD_BYTES``; and each once more under
torch.profiler for its device time per launch alone.  Prints the card,
one line per case and a JSON object with the medians and spreads of the
six runs of each kernel; writes it to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: The earlier libraries: source -> (ABI entry point, its argument types).
_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64 = ctypes.c_longlong
PARENT_ABI = {
    "flash_causal_attention": ("flash_causal_attention_bf16",
                               [_PTR] * 5 + [_INT] * 5 + [_F32, _F32, _INT, _PTR]),
    "flash_decode_attention": ("flash_decode_attention_launch",
                               [_PTR] * 7 + [_INT] * 5
                               + [_I64, _I64, _INT, _F32, _F32, _INT, _PTR]),
    "fused_decode_layer": ("fused_decode_layer_launch",
                           [_PTR] * 11 + [_INT] * 9 + [_F32, _F32, _INT, _PTR]),
    "ragged_prefill_attention": ("ragged_prefill_attention_launch",
                                 [_PTR] * 14 + [_INT] * 9 + [_F32, _F32, _INT, _PTR]),
}
#: ``--kernels`` numbers -> library names.
KERNELS = {"1": "flash_causal_attention", "2": "flash_decode_attention",
           "4": "fused_decode_layer", "6": "ragged_prefill_attention"}
#: The kernels' names as the profiler reports them (earlier, current).
DEVICE_NAMES = {"flash_causal_attention": ("flash_causal_kernel",) * 2,
                "flash_decode_attention": ("flash_decode_kernel",) * 2,
                "fused_decode_layer": ("fused_decode_kernel",
                                       "fused_decode_layer_kernel"),
                "ragged_prefill_attention": ("ragged_prefill_kernel",) * 2}
#: Kernel 2's views: the serving bucket in every form, the others raw.
DECODE_VIEWS = {None: (128, 256, 512, 1024), "int8": (512,), "int4": (512,)}
PREFILL_T = (128, 256, 512, 1024)


def build_parents(src_dir: Path, names) -> dict:
    """The earlier sources' libraries, one nvcc each, started together."""
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for name in names:
        lib = out_dir / f"lib{name}_parent.so"
        cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", str(lib),
               str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"earlier {name} build failed:\n{report}")
        so = ctypes.CDLL(str(lib))
        fn = getattr(so, PARENT_ABI[name][0])
        fn.restype = ctypes.c_int
        fn.argtypes = PARENT_ABI[name][1]
        libs[name] = fn
    print(f"[ab] earlier sources built in {time.monotonic() - t0:.1f} s")
    return libs


def parent_prefill(fn, q, k, v, valid):
    """One launch of the earlier kernel 1 (no window, no soft cap)."""
    import torch

    b, t, h, d = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), b, t, h, k.shape[2], d, float(d ** -0.5), 0.0, t + 1,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel 1 launch failed: cuda error {rc}")
    return out


def parent_decode(fn, q, kn, vn, cache, pos, layer, kw):
    """One launch of the earlier kernel 4, with the wrapper's arguments."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import KV_FORMS, _NO_WINDOW

    form = kw["kv_quant"]
    b, h, d = q.shape
    kc, vc, ks, vs = cache
    s = kc.shape[2] * (2 if form == "int4" else 1)
    sin, cos = kw["rope"]
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
            sin.data_ptr(), cos.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, s, h, kn.shape[1], d, kc.shape[0], layer, min(kw["kv_view"], s),
            KV_FORMS[form], float(d ** -0.5), 0.0, _NO_WINDOW,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel 4 launch failed: cuda error {rc}")
    return out


def parent_slot_decode(fn, q, k_view, v_view, pos, kw):
    """One launch of the earlier kernel 2 on strided cache windows."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import KV_FORMS, _NO_WINDOW

    form = kw.get("kv_quant")
    b, _, h, d = q.shape
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    s = k_view.shape[1] * (2 if form == "int4" else 1)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, s, h, k_view.shape[2], d, k_view.stride(0),
            0 if ks is None else ks.stride(0), KV_FORMS[form],
            float(d ** -0.5), 0.0, _NO_WINDOW,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel 2 launch failed: cuda error {rc}")
    return out


def parent_ragged(fn, q, kn, vn, kc, vc, slot_of, start_of, qoff_of, base_of,
                  layer, *, k_scale=None, v_scale=None, kv_quant=None,
                  block_q, rope_theta, window=None, softcap=None):
    """One launch of the earlier kernel 6, with the wrapper's arguments."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa
    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import KV_FORMS, _NO_WINDOW

    tot, h, d = q.shape
    s = kc.shape[2] * (2 if kv_quant == "int4" else 1)
    sin, cos = pa.rope_tables(s, d, rope_theta, q.device)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(), sin.data_ptr(),
            cos.data_ptr(), slot_of.data_ptr(), start_of.data_ptr(),
            qoff_of.data_ptr(), base_of.data_ptr(), out.data_ptr(),
            tot // block_q, h, kn.shape[1], d, block_q, kc.shape[1], s, layer,
            KV_FORMS[kv_quant], float(d ** -0.5),
            0.0 if softcap is None else float(softcap),
            _NO_WINDOW if window is None else int(window),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel 6 launch failed: cuda error {rc}")
    return out


def compare(kname: str, case: dict, old_fn, new_fn, iters: int, card: str) -> dict:
    """Time the pair in turns and under the profiler; one result row."""
    times = {"earlier": [], "current": []}
    for who in ("earlier", "current", "current", "earlier"):
        times[who] += cs.run_times(new_fn if who == "current" else old_fn, iters)
    row = dict(name=kname, **case)
    for who, ts in times.items():
        row[f"{who}_ms"] = statistics.median(ts)
        row[f"{who}_spread"] = max(ts) - min(ts)
    for who, fn, dev in zip(("earlier", "current"), (old_fn, new_fn),
                            DEVICE_NAMES[kname.split("_int")[0]]):
        row[f"{who}_device_ms"] = cs.device_ms(fn, dev)
    row["ratio"] = row["current_ms"] / row["earlier_ms"]
    row["device_ratio"] = row["current_device_ms"] / row["earlier_device_ms"]
    print(f"[ab] {kname} {case['shape']}: earlier {row['earlier_ms']:.4f} ms "
          f"(spread {row['earlier_spread']:.4f}; device "
          f"{row['earlier_device_ms']:.4f}), current {row['current_ms']:.4f} ms "
          f"(spread {row['current_spread']:.4f}; device "
          f"{row['current_device_ms']:.4f}), ratio {row['ratio']:.3f} (device "
          f"{row['device_ratio']:.3f}); max |current - earlier| "
          f"{case['max_abs_diff']:.3e} ({card})")
    return row


def prefill_ab(fn, h, kh, d, card) -> list:
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa

    rows = []
    for t in PREFILL_T:
        b = 8
        g = torch.Generator(device="cuda").manual_seed(t)
        in_bytes = 2 * b * t * (h + 2 * kh) * d + b * t
        sets = max(2, -(-int(cs.L2_COLD_BYTES) // in_bytes) + 1)
        ins = []
        for _ in range(sets):
            q = torch.randn((b, t, h, d), generator=g, device="cuda").bfloat16()
            k = torch.randn((b, t, kh, d), generator=g, device="cuda").bfloat16()
            v = torch.randn((b, t, kh, d), generator=g, device="cuda").bfloat16()
            ins.append((q, k, v, torch.ones((b, t), dtype=torch.bool, device="cuda")))
        got = fa.flash_causal_attention(*ins[0])
        old = parent_prefill(fn, *ins[0])
        torch.cuda.synchronize()
        shape = f"B{b} T{t} H{h} K{kh} D{d} L2-cold{sets}"
        diff = cs.check_close(f"flash_causal_attention {shape}", got, old,
                              ref="the earlier kernel")
        rows.append(compare(
            "flash_causal_attention", dict(shape=shape, max_abs_diff=diff),
            cs.rotating(lambda n: parent_prefill(fn, *ins[n]), sets),
            cs.rotating(lambda n: fa.flash_causal_attention(*ins[n]), sets),
            20, card))
        del ins, got, old
        torch.cuda.empty_cache()
    return rows


def decode_ab(fn, h, kh, d, card) -> list:
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd

    rows = []
    b = cs.NUM_SLOTS + 1
    positions = cs.decode_positions(b, cs.FUSED_VIEW)
    for form in cs.FORMS:
        layers = cs.cold_layers(positions, cs.FUSED_VIEW, kh, d, form)
        q, kn, vn, orig, pos, kw = cs.fused_inputs(
            h, kh, d, form, cs.FUSED_VIEW, cs.MAX_SEQ, layers, seed=0)
        c_new = [None if x is None else x.clone() for x in orig]
        c_old = orig
        layer = layers - 1
        got = fd.fused_decode_layer(q, kn, vn, *c_new, pos, layer, **kw)
        old = parent_decode(fn, q, kn, vn, c_old, pos, layer, kw)
        torch.cuda.synchronize()
        rname = cs.row_name("fused_decode_layer", form)
        live = pos < cs.FUSED_VIEW
        diff = cs.check_close(rname, got[live], old[live], ref="the earlier kernel")
        for leaf, x, y in zip(("k", "v", "k_scale", "v_scale"), c_new, c_old):
            if x is not None and not torch.equal(x, y):
                raise AssertionError(f"{rname}: cache leaf {leaf} differs from "
                                     f"the earlier kernel's")
        shape = f"B{b} view{cs.FUSED_VIEW} S{cs.MAX_SEQ} H{h} K{kh} D{d} L2-cold{layers}"
        rows.append(compare(
            rname, dict(shape=shape, max_abs_diff=diff),
            cs.rotating(lambda lay: parent_decode(fn, q, kn, vn, c_old, pos, lay, kw),
                        layers),
            cs.rotating(lambda lay: fd.fused_decode_layer(
                q, kn, vn, *c_new, pos, lay, **kw), layers),
            50, card))
        del q, kn, vn, orig, c_new, c_old, got, old
        torch.cuda.empty_cache()
    return rows


def slot_decode_ab(fn, h, kh, d, card) -> list:
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

    rows = []
    b = cs.NUM_SLOTS + 1
    for form in cs.FORMS:
        for s in DECODE_VIEWS[form]:
            positions = cs.decode_positions(b, s)
            layers = cs.cold_layers(positions, s, kh, d, form)
            q, pos, view = cs.decode_inputs(b, s, h, kh, d, positions, form,
                                            cs.MAX_SEQ, layers, seed=0)
            kv, vv, kw = view(layers - 1)
            got = da.flash_decode_attention(q, kv, vv, pos, **kw)
            old = parent_slot_decode(fn, q, kv, vv, pos, kw)
            torch.cuda.synchronize()
            rname = cs.row_name("flash_decode_attention", form)
            diff = cs.check_close(rname, got, old, ref="the earlier kernel")
            shape = f"B{b} S{s} H{h} K{kh} D{d} L2-cold{layers}"
            views = [view(lay) for lay in range(layers)]
            rows.append(compare(
                rname, dict(shape=shape, max_abs_diff=diff),
                cs.rotating(lambda lay: parent_slot_decode(
                    fn, q, views[lay][0], views[lay][1], pos, views[lay][2]), layers),
                cs.rotating(lambda lay: da.flash_decode_attention(
                    q, views[lay][0], views[lay][1], pos, **views[lay][2]), layers),
                50, card))
            del q, pos, view, views, got, old
            torch.cuda.empty_cache()
    return rows


def ragged_ab(fn, h, kh, d, card) -> list:
    import torch

    from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa

    rows = []
    entries = [(i, st, ln) for i, (st, ln) in enumerate(cs.RAGGED_ROWS)]
    slot_of, start_of, qoff_of, _qlen, base_of, offs = pa.plan_ragged_group(
        entries, 16, cs.RAGGED_TOT, scratch_slot=cs.NUM_SLOTS)
    descs = [torch.tensor(x, device="cuda") for x in (slot_of, start_of, qoff_of, base_of)]
    hist = sum(st for st, _ in cs.RAGGED_ROWS)
    for form in cs.FORMS:
        eb = cs.ELEM_BYTES[form]
        per_set = (2 * cs.RAGGED_TOT * (h + 2 * kh) * d
                   + hist * kh * (2 * d * eb + (8 if form else 0)))
        sets = max(2, -(-int(cs.L2_COLD_BYTES) // int(per_set)) + 1)
        g = torch.Generator(device="cuda").manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()

        ins = [(rnd(cs.RAGGED_TOT, h, d), rnd(cs.RAGGED_TOT, kh, d),
                rnd(cs.RAGGED_TOT, kh, d)) for _ in range(sets)]
        kc, ks = cs.cache_form(rnd(sets, cs.NUM_SLOTS + 1, cs.MAX_SEQ, kh, d), form, 2)
        vc, vs = cs.cache_form(rnd(sets, cs.NUM_SLOTS + 1, cs.MAX_SEQ, kh, d), form, 2)
        c_new = [None if x is None else x.clone() for x in (kc, vc, ks, vs)]
        c_old = [kc, vc, ks, vs]
        kw = dict(block_q=16, rope_theta=500000.0, kv_quant=form)

        def run_new(n, c=c_new):
            return pa.ragged_prefill_attention(
                *ins[n], c[0], c[1], *descs, n, k_scale=c[2], v_scale=c[3], **kw)

        def run_old(n, c=c_old):
            return parent_ragged(fn, *ins[n], c[0], c[1], *descs, n,
                                 k_scale=c[2], v_scale=c[3], **kw)

        got, old = run_new(sets - 1), run_old(sets - 1)
        torch.cuda.synchronize()
        rname = cs.row_name("ragged_prefill_attention", form)
        real = torch.cat([torch.arange(o, o + ln, device="cuda")
                          for (_, _, ln), o in zip(entries, offs)])
        diff = cs.check_close(rname, got[real], old[real], ref="the earlier kernel")
        for leaf, x, y in zip(("k", "v", "k_scale", "v_scale"), c_new, c_old):
            if x is None:
                continue
            if form is None:
                diff = max(diff, cs.check_close(f"{rname} cache {leaf}", x[:, :-1],
                                                y[:, :-1], ref="the earlier kernel"))
            elif not torch.equal(x[:, :-1], y[:, :-1]):
                raise AssertionError(f"{rname}: cache leaf {leaf} differs from "
                                     f"the earlier kernel's")
        shape = f"rows{len(entries)} TOT{cs.RAGGED_TOT} H{h} K{kh} D{d} L2-cold{sets}"
        rows.append(compare(rname, dict(shape=shape, max_abs_diff=diff),
                            cs.rotating(run_old, sets), cs.rotating(run_new, sets),
                            20, card))
        del ins, kc, vc, ks, vs, c_new, c_old, got, old
        torch.cuda.empty_cache()
    return rows


#: The A/B of each kernel: its cases at llama3-8b's head geometry.
AB_CASES = {"flash_causal_attention": prefill_ab,
            "flash_decode_attention": slot_decode_ab,
            "fused_decode_layer": decode_ab,
            "ragged_prefill_attention": ragged_ab}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True,
                    help="directory holding the earlier sources of the "
                         "compared kernels and their headers")
    ap.add_argument("--kernels", default="1,4",
                    help="comma-separated kernel numbers to compare, of "
                         + ", ".join(KERNELS))
    args = ap.parse_args()
    try:
        names = [KERNELS[k.strip()] for k in args.kernels.split(",")]
    except KeyError as e:
        ap.error(f"--kernels: no kernel {e}")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from p2p_llm_tunnel_tpu_torch import models  # noqa: F401  (import order)
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    name = cs.card()
    print(name)
    kernel_build.build(names)
    parents = build_parents(args.parent_src, names)
    cfg = get_config(cs.MODEL)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    result = []
    for kname in names:
        result += AB_CASES[kname](parents[kname], h, kh, d, name)
    line = json.dumps({"card": name, "ab": result})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
