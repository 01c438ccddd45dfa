#!/usr/bin/env python3
"""A/B of the plane decode kernel (kernel 3) against an earlier source of
it, on one NVIDIA card, with ``chip_smoke.py``'s L2-cold harness.

    mkdir -p build/plane_ab_parent
    for f in flash_decode_attention_plane.cu decode_tile.cuh; do
      git show <commit>:p2p_llm_tunnel_tpu_torch/csrc/$f > build/plane_ab_parent/$f
    done
    python3 scripts/plane_kernel_ab.py --parent-src build/plane_ab_parent

The earlier source must export the single-block C ABI of commit 75501a8,
``flash_decode_attention_plane_launch(q, k, v, positions, out, B, S, H, KH,
D, slot_stride, scale, softcap, window, stream)``.  It is built with the
port's nvcc flags into ``build/plane_ab/``; the current source through
``ops/kernel_build.py``.  At llama3-8b's head geometry (B 17, 32/8 heads,
D 128) and each of ``chip_smoke.PLANE_VIEWS`` (512, 1024, 4096, each with
one row parked past the plane, ``chip_smoke.plane_positions``), both
kernels run on the same inputs (outputs within ``chip_smoke.ATOL`` /
``RTOL`` of each other), then are timed in turns (earlier, current,
current, earlier), three runs of 50 launches each (CUDA events), the layer
rotating over a stacked cache whose live bytes exceed
``chip_smoke.L2_COLD_BYTES``, and each once more under torch.profiler for
its device time per launch alone.  Prints the card, one line per view
and a JSON object with the medians and spreads of the six runs of each
kernel; writes it to ``chiprun_out/plane_kernel_ab.json``.
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

    out_dir = ROOT / "build" / "plane_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash_decode_attention_plane_parent.so"
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", str(lib),
           str(src_dir / "flash_decode_attention_plane.cu")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"parent build failed:\n{proc.stdout}{proc.stderr}")
    print(f"[ab] earlier source built in {time.monotonic() - t0:.1f} s")
    so = ctypes.CDLL(str(lib))
    fn = so.flash_decode_attention_plane_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    return so


def parent_call(so, q, kc, vc, pos):
    """One launch of the earlier kernel, with the wrapper's arguments."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import _NO_WINDOW

    b, _, h, d = q.shape
    out = torch.empty_like(q)
    rc = so.flash_decode_attention_plane_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, kc.shape[1], h, kc.shape[2], d, kc.stride(0), float(d ** -0.5), 0.0,
        _NO_WINDOW, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel launch failed: cuda error {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True,
                    help="directory holding the earlier "
                         "flash_decode_attention_plane.cu and its header")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("plane_kernel_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from p2p_llm_tunnel_tpu_torch import models  # noqa: F401  (import order)
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    name = cs.card()
    print(name)
    kernel_build.build(["flash_decode_attention_plane"])
    so = build_parent(args.parent_src)
    cfg = get_config(cs.MODEL)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = cs.NUM_SLOTS + 1
    result = []
    for s in cs.PLANE_VIEWS:
        positions = cs.plane_positions(b, s)
        layers = cs.cold_layers(positions, s, kh, d, None)
        q, pos, view = cs.decode_inputs(b, s, h, kh, d, positions, None,
                                        max(cs.MAX_SEQ, s), layers, seed=0)
        views = [view(lay)[:2] for lay in range(layers)]
        got = da.flash_decode_attention_plane(q, *views[0], pos)
        old = parent_call(so, q, *views[0], pos)
        torch.cuda.synchronize()
        diff = cs.check_close(f"flash_decode_attention_plane S{s}", got, old,
                              ref="the earlier kernel")
        new_fn = cs.rotating(lambda lay: da.flash_decode_attention_plane(
            q, *views[lay], pos), layers)
        old_fn = cs.rotating(lambda lay: parent_call(so, q, *views[lay], pos), layers)
        times = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            times[who] += cs.run_times(new_fn if who == "current" else old_fn, iters=50)
        plan = da.plane_plan(b, s, kh, h // kh, d)
        row = dict(view=s, layers=layers, max_abs_diff=diff,
                   plan=dict(cluster=plan.cluster, tiles_per_cta=plan.tiles_per_cta,
                             stages=plan.stages, smem_bytes=plan.smem_bytes))
        for who, ts in times.items():
            row[f"{who}_ms"] = statistics.median(ts)
            row[f"{who}_spread"] = max(ts) - min(ts)
        for who, fn in (("earlier", old_fn), ("current", new_fn)):
            row[f"{who}_device_ms"] = cs.device_ms(fn, "plane_decode_kernel")
        row["ratio"] = row["current_ms"] / row["earlier_ms"]
        dev = (row["current_device_ms"], row["earlier_device_ms"])
        row["device_ratio"] = None if None in dev else dev[0] / dev[1]
        print(f"[ab] flash_decode_attention_plane B{b} S{s} H{h} K{kh} D{d} "
              f"parked{sum(p >= s for p in positions)} L2-cold over {layers} layers: "
              f"earlier {row['earlier_ms']:.4f} ms (spread {row['earlier_spread']:.4f}; "
              f"device {cs.fmt_ms(dev[1])}), current {row['current_ms']:.4f} ms "
              f"(spread {row['current_spread']:.4f}; device {cs.fmt_ms(dev[0])}; "
              f"cluster {plan.cluster} x {plan.tiles_per_cta} tiles), ratio "
              f"{row['ratio']:.3f} (device {row['device_ratio']}); max |current - "
              f"earlier| {diff:.3e} ({name})")
        result.append(row)
        del q, pos, view, views
        torch.cuda.empty_cache()
    line = json.dumps({"card": name, "ab": result})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "plane_kernel_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
