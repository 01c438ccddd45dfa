#!/usr/bin/env python3
"""A/B of the fused verify kernel (kernel 5) against an earlier source of
it, on one NVIDIA card, with ``chip_smoke.py``'s L2-cold harness.

    mkdir -p build/spec_ab_parent
    for f in fused_spec_decode_layer.cu decode_tile.cuh kv_forms.cuh; do
      git show <commit>:p2p_llm_tunnel_tpu_torch/csrc/$f > build/spec_ab_parent/$f
    done
    python3 scripts/spec_kernel_ab.py --parent-src build/spec_ab_parent

The earlier source must export the single-block C ABI
``fused_spec_decode_layer_launch(q, k_new, v_new, k_cache, v_cache, k_scale,
v_scale, sin, cos, positions, out, B, T, S, H, KH, D, L, layer, view, form,
scale, softcap, window, stream)``.  It is built with the port's nvcc flags
into ``build/spec_ab/``; the current source through
``ops/kernel_build.py``.  For each KV form at llama3-8b's head geometry
and the serving positions (B 17, view 512 over a 1024-position cache), at
T 5 and T 9, both kernels run on the same inputs (outputs within
``chip_smoke.ATOL``/``RTOL`` of each other, appended caches bit-exact),
then are timed in turns (earlier, current, current, earlier), three runs
of 50 launches each (CUDA events), the layer rotating over a stacked
cache whose live bytes exceed ``chip_smoke.L2_COLD_BYTES``, and each once
more under torch.profiler for its device time per launch alone.  Prints
the card, one line per case and a JSON object with the medians and
spreads of the six runs of each kernel; writes it to
``chiprun_out/spec_kernel_ab.json``.
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


def build_parent(src_dir: Path) -> ctypes.CDLL:
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    out_dir = ROOT / "build" / "spec_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libfused_spec_decode_layer_parent.so"
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", str(lib),
           str(src_dir / "fused_spec_decode_layer.cu")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"parent build failed:\n{proc.stdout}{proc.stderr}")
    print(f"[ab] earlier source built in {time.monotonic() - t0:.1f} s")
    so = ctypes.CDLL(str(lib))
    fn = so.fused_spec_decode_layer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return so


def parent_call(so, q, kn, vn, cache, pos, layer, kw):
    """One launch of the earlier kernel, with the wrapper's arguments."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import KV_FORMS, _NO_WINDOW

    form = kw["kv_quant"]
    b, t, h, d = q.shape
    kc, vc, ks, vs = cache
    s = kc.shape[2] * (2 if form == "int4" else 1)
    sin, cos = kw["rope"]
    out = torch.empty_like(q)
    rc = so.fused_spec_decode_layer_launch(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        sin.data_ptr(), cos.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, t, s, h, kn.shape[2], d, kc.shape[0], layer, min(kw["kv_view"], s),
        KV_FORMS[form], float(d ** -0.5), 0.0, _NO_WINDOW,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel launch failed: cuda error {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True,
                    help="directory holding the earlier fused_spec_decode_layer.cu "
                         "and its headers")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("spec_kernel_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from p2p_llm_tunnel_tpu_torch import models  # noqa: F401  (import order)
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.ops import fused_spec_decode as fs
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    name = cs.card()
    print(name)
    kernel_build.build(["fused_spec_decode_layer"])
    so = build_parent(args.parent_src)
    cfg = get_config(cs.MODEL)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = cs.NUM_SLOTS + 1
    positions = cs.spec_positions(b, cs.FUSED_VIEW)
    result = []
    for t in (cs.SPEC_T, 9):
        for form in cs.FORMS:
            layers = cs.cold_layers(positions, cs.FUSED_VIEW, kh, d, form)
            q, kn, vn, orig, pos, kw = cs.spec_inputs(
                h, kh, d, form, t, cs.FUSED_VIEW, cs.MAX_SEQ, layers, seed=0)
            c_new = [None if x is None else x.clone() for x in orig]
            c_old = orig
            layer = layers - 1
            got = fs.fused_spec_decode_layer(q, kn, vn, *c_new, pos, layer, **kw)
            old = parent_call(so, q, kn, vn, c_old, pos, layer, kw)
            torch.cuda.synchronize()
            live = (pos[:, None].long()
                    + torch.arange(t, device="cuda")[None, :]) < cs.FUSED_VIEW
            rname = cs.row_name("fused_spec_decode_layer", form)
            diff = cs.check_close(f"{rname} T{t}", got[live], old[live],
                                  ref="the earlier kernel")
            for leaf, x, y in zip(("k", "v", "k_scale", "v_scale"), c_new, c_old):
                if x is not None and not torch.equal(x, y):
                    raise AssertionError(f"{rname} T{t}: cache leaf {leaf} differs "
                                         f"from the earlier kernel's")
            new_fn = cs.rotating(lambda lay: fs.fused_spec_decode_layer(
                q, kn, vn, *c_new, pos, lay, **kw), layers)
            old_fn = cs.rotating(lambda lay: parent_call(
                so, q, kn, vn, c_old, pos, lay, kw), layers)
            times = {"earlier": [], "current": []}
            for who in ("earlier", "current", "current", "earlier"):
                times[who] += cs.run_times(new_fn if who == "current" else old_fn, iters=50)
            row = dict(name=rname, t=t, layers=layers, max_abs_diff=diff)
            for who, ts in times.items():
                row[f"{who}_ms"] = statistics.median(ts)
                row[f"{who}_spread"] = max(ts) - min(ts)
            for who, fn in (("earlier", old_fn), ("current", new_fn)):
                row[f"{who}_device_ms"] = cs.device_ms(fn, "fused_spec_kernel")
            row["ratio"] = row["current_ms"] / row["earlier_ms"]
            row["device_ratio"] = row["current_device_ms"] / row["earlier_device_ms"]
            print(f"[ab] {rname} T{t} B{b} view{cs.FUSED_VIEW} L2-cold over {layers} "
                  f"layers: earlier {row['earlier_ms']:.4f} ms (spread "
                  f"{row['earlier_spread']:.4f}; device {row['earlier_device_ms']:.4f}), "
                  f"current {row['current_ms']:.4f} ms (spread "
                  f"{row['current_spread']:.4f}; device {row['current_device_ms']:.4f}), "
                  f"ratio {row['ratio']:.3f} (device {row['device_ratio']:.3f}); "
                  f"max |current - earlier| {diff:.3e} ({name})")
            result.append(row)
            del q, kn, vn, orig, c_new, c_old
            torch.cuda.empty_cache()
    line = json.dumps({"card": name, "ab": result})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "spec_kernel_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
