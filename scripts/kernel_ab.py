#!/usr/bin/env python3
"""A/B of the prefill flash kernel (kernel 1) and the fused decode layer
(kernel 4) against an earlier source of each, on one NVIDIA card, with
``chip_smoke.py``'s L2-cold harness.

    mkdir -p build/kernel_ab_parent
    for f in flash_causal_attention.cu fused_decode_layer.cu decode_tile.cuh \\
             kv_forms.cuh; do
      git show <commit>:p2p_llm_tunnel_tpu_torch/csrc/$f > build/kernel_ab_parent/$f
    done
    python3 scripts/kernel_ab.py --parent-src build/kernel_ab_parent

The earlier sources must export the C ABIs
``flash_causal_attention_bf16(q, k, v, valid, out, B, T, H, KH, D, scale,
softcap, window, stream)`` and the single-block
``fused_decode_layer_launch(q, k_new, v_new, k_cache, v_cache, k_scale,
v_scale, sin, cos, positions, out, B, S, H, KH, D, L, layer, view, form,
scale, softcap, window, stream)``.  They are built with the port's nvcc
flags into ``build/kernel_ab/`` (two nvcc processes, started together); the
current sources through ``ops/kernel_build.py``.

Kernel 1 runs at llama3-8b's head geometry, B 8 and T 128/256/512/1024
(the plain loop's prefill waves), every row valid; kernel 4 in each KV form
at the decode positions (B 17, view 512 over a 1024-position cache).  Both
kernels of a pair run on the same inputs — outputs within
``chip_smoke.ATOL``/``RTOL`` of each other, kernel 4's appended caches and
scales bit-exact — then are timed in turns (earlier, current, current,
earlier), three runs of 20 (kernel 1) or 50 (kernel 4) launches each (CUDA
events), L2-cold: kernel 1 rotates over copies of its inputs, kernel 4 the
layer over a stacked cache, whose bytes exceed ``chip_smoke.L2_COLD_BYTES``;
and each once more under torch.profiler for its device time per launch
alone.  Prints the card, one line per case and a JSON object with the
medians and spreads of the six runs of each kernel; writes it to
``chiprun_out/kernel_ab.json``.
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
PARENT_ABI = {
    "flash_causal_attention": ("flash_causal_attention_bf16",
                               [_PTR] * 5 + [_INT] * 5 + [_F32, _F32, _INT, _PTR]),
    "fused_decode_layer": ("fused_decode_layer_launch",
                           [_PTR] * 11 + [_INT] * 9 + [_F32, _F32, _INT, _PTR]),
}
#: The kernels' names as the profiler reports them (earlier, current).
DEVICE_NAMES = {"flash_causal_attention": ("flash_causal_kernel",) * 2,
                "fused_decode_layer": ("fused_decode_kernel",
                                       "fused_decode_layer_kernel")}
PREFILL_T = (128, 256, 512, 1024)


def build_parents(src_dir: Path) -> dict:
    """The earlier sources' libraries, one nvcc each, started together."""
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for name in PARENT_ABI:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True,
                    help="directory holding the earlier flash_causal_attention.cu, "
                         "fused_decode_layer.cu and their headers")
    args = ap.parse_args()

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
    kernel_build.build(list(PARENT_ABI))
    parents = build_parents(args.parent_src)
    cfg = get_config(cs.MODEL)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    result = prefill_ab(parents["flash_causal_attention"], h, kh, d, name)
    result += decode_ab(parents["fused_decode_layer"], h, kh, d, name)
    line = json.dumps({"card": name, "ab": result})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
