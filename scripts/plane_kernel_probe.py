#!/usr/bin/env python3
"""Where kernel 3's time goes: its launch plans swept, and the phases of
its CTAs stamped, on one NVIDIA card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 scripts/plane_kernel_probe.py [--out FILE]

At llama3-8b's head geometry (B 17, 32/8 heads, D 128), L2-cold as in
``chip_smoke.py`` (the layer rotates over a stacked cache whose live bytes
exceed ``chip_smoke.L2_COLD_BYTES``):

- plans: the device time per launch (torch.profiler) of every cluster
  size 1, 2, 4 and 8 at every ring depth 1 and 2, through the kernel's C
  ABI, at views 512, 1024 and 4096 on ``chip_smoke.plane_positions``, and
  at view 512 with every slot at position 0 (one tile a slot, the fixed
  cost of a CTA) and with every slot parked (the whole plane); each launch
  is checked against the plain version first;
- phases: a copy of ``csrc/flash_decode_attention_plane.cu`` whose thread 0
  stamps ``%globaltimer`` at each phase of its CTA (start, set up, first
  tile landed, tiles done, warp partials written, CTA partial written and
  the first cluster barrier passed, rank 0's merge done, second barrier
  passed), built by nvcc into ``build/plane_kernel_probe/``, launched on
  ``ops/decode_attention.plane_plan``'s plan and the others named below;
  per plan the launch's span, the spread of CTA start times (a second
  wave starts late) and the median and max of each phase over the CTAs.

The card's name and power limit head the output; ``--out FILE`` also
writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

B, H, KH, D = cs.NUM_SLOTS + 1, 32, 8, 128
#: Position sets: the serving rows, every slot at 0, every slot parked.
POSITIONS = {
    "serve": cs.plane_positions,
    "all0": lambda b, s: [0] * b,
    "parked": lambda b, s: [s] * b,
}
SWEEP = ((512, "serve"), (512, "all0"), (512, "parked"), (1024, "serve"),
         (4096, "serve"))
#: (view, positions, cluster); the ring depth and tiles follow from them.
PHASE_RUNS = ((512, "serve", 2), (512, "serve", 4), (512, "all0", 1),
              (512, "all0", 2), (512, "all0", 4), (1024, "serve", 2),
              (4096, "serve", 2))
PHASES = ("start", "set up", "first tile", "tiles done", "warp partials",
          "barrier 1", "merged", "barrier 2")

_STAMP = ("if (threadIdx.x == 0) {{ unsigned long long t_; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "g_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
          "blockIdx.x) * 8 + {i}] = t_; }}")
#: (anchor, text, whether the text goes before the anchor) in the source.
_EDITS = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[1 << 17];\n", True),
    ("  const int n = max(min(t0 + tiles_per_cta, last / TILE + 1) - t0, 0);\n",
     _STAMP.format(i=0) + "\n", False),
    ("    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
     "  }\n  __syncthreads();\n",
     _STAMP.format(i=1) + "\n  if (n == 0) {" + _STAMP.format(i=2) + "}\n", False),
    ("      mbar_wait(full + s, (i / stages) & 1);\n",
     "      if (i == 0) {" + _STAMP.format(i=2) + "}\n", False),
    ("        l[j] = __fadd_rn(l[j], __shfl_xor_sync(0xffffffffu, l[j], off));\n",
     _STAMP.format(i=3) + "\n", False),
    ("        wp.acc[(2 * (lane & 3) + (e & 1)) * D + d + (e >> 1) * 8] = acc[dc][e];\n"
     "    }\n  }\n  __syncthreads();\n", _STAMP.format(i=4) + "\n", False),
    ("  cluster.sync();  // every rank's partial is written\n",
     _STAMP.format(i=5) + "\n", False),
    ("          __fdiv_rn(merged_acc<D>(src, nrank, fac, g, i), fmaxf(fsum[g], 1e-30f)));\n"
     "    }\n  }\n", _STAMP.format(i=6) + "\n", False),
    ("  cluster.sync();  // every rank stays resident until rank 0 has read it\n",
     _STAMP.format(i=7) + "\n", False),
)
_COPY_OUT = '''
extern "C" int plane_probe_stamps(void* dst, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, bytes, 0,
                                               cudaMemcpyDeviceToDevice));
}
'''


def _argtypes(fn):
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def build_stamped(kernel_build) -> ctypes.CDLL:
    """The kernel's source with its phase stamps, built with the port's
    nvcc flags."""
    text = (kernel_build.CSRC_DIR / "flash_decode_attention_plane.cu").read_text()
    for anchor, add, before in _EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in the source: {anchor!r}")
        text = text.replace(anchor, add + anchor if before else anchor + add)
    out = ROOT / "build" / "plane_kernel_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_decode_attention_plane_stamped.cu"
    src.write_text(text + _COPY_OUT)
    lib = out / "libplane_stamped.so"
    proc = subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS,
                           "-I", str(kernel_build.CSRC_DIR), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"stamped build failed:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    _argtypes(so.flash_decode_attention_plane_launch)
    so.plane_probe_stamps.restype = ctypes.c_int
    so.plane_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return so


def launch(so, q, kc, vc, pos, cluster, tiles, stages):
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.decode_attention import _NO_WINDOW

    out = torch.empty_like(q)
    rc = so.flash_decode_attention_plane_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, kc.shape[1], H, KH, D, kc.stride(0), D ** -0.5, 0.0, _NO_WINDOW,
        cluster, tiles, stages, 2048 + stages * 2 * 64 * D * 2,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch of cluster {cluster} x {tiles} tiles, "
                           f"{stages} stages failed: cuda error {rc}")
    return out


def inputs(s, posname):
    """q, positions and the stacked cache's layer views; the layer count
    of the serving rows, so every position set rotates over as many."""
    layers = cs.cold_layers(cs.plane_positions(B, s), s, KH, D, None)
    q, pos, view = cs.decode_inputs(B, s, H, KH, D, POSITIONS[posname](B, s), None,
                                    max(cs.MAX_SEQ, s), layers, seed=0)
    return q, pos, [view(lay)[:2] for lay in range(layers)]


def sweep(so, da) -> list:
    rows = []
    for s, posname in SWEEP:
        q, pos, views = inputs(s, posname)
        want = da.plain(q, *views[0], pos)
        tiles = s // 64
        times = {}
        for c in (1, 2, 4, 8):
            per = -(-tiles // c)
            for st in (1, 2):
                if st > per:
                    continue
                cs.check_close(f"kernel 3 S{s} {posname} cluster {c}",
                               launch(so, q, *views[0], pos, c, per, st), want)
                fn = cs.rotating(lambda lay: launch(so, q, *views[lay], pos, c, per, st),
                                 len(views))
                times[f"C{c}xT{per} st{st}"] = cs.device_ms(fn, "plane_decode_kernel")
        plan = da.plane_plan(B, s, KH, H // KH, D)
        rows.append(dict(view=s, positions=posname, layers=len(views),
                         plan=f"C{plan.cluster}xT{plan.tiles_per_cta} st{plan.stages}",
                         device_ms=times))
        print(f"[plans] S{s} {posname} (plan C{plan.cluster}xT{plan.tiles_per_cta} "
              f"st{plan.stages}): " + "  ".join(f"{k} {cs.fmt_ms(v)}"
                                                 for k, v in times.items()), flush=True)
        del q, pos, views
    return rows


def phases(so, da) -> list:
    import torch

    rows = []
    for s, posname, c in PHASE_RUNS:
        q, pos, views = inputs(s, posname)
        per = -(-(s // 64) // c)
        st = min(per, 2)
        for lay in range(len(views) + 2):  # the last launch's stamps are read
            launch(so, q, *views[lay % len(views)], pos, c, per, st)
        torch.cuda.synchronize()
        n = c * KH * B
        buf = torch.zeros(n * 8, dtype=torch.int64, device="cuda")
        if so.plane_probe_stamps(buf.data_ptr(), n * 8 * 8):
            raise RuntimeError("reading the stamps failed")
        t = buf.view(n, 8).double().cpu()
        us = (t - t[:, 0].min()) / 1e3

        def med_max(x):
            x = x.sort().values
            return round(x[len(x) // 2].item(), 3), round(x[-1].item(), 3)

        row = dict(view=s, positions=posname, cluster=c, tiles_per_cta=per, stages=st,
                   span_us=round(us[:, 7].max().item(), 3),
                   start_us=med_max(us[:, 0]), life_us=med_max(us[:, 7] - us[:, 0]),
                   phases_us={f"{PHASES[i]} -> {PHASES[i + 1]}": med_max(us[:, i + 1] - us[:, i])
                              for i in range(7)})
        rows.append(row)
        print(f"[phases] S{s} {posname} cluster {c} x {per} tiles, {st} stages: span "
              f"{row['span_us']} us, CTA start median/max {row['start_us']}, life "
              f"{row['life_us']}; " + ", ".join(f"{k} {v}" for k, v in row["phases_us"].items()),
              flush=True)
        del q, pos, views
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the rows as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("plane_kernel_probe: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from p2p_llm_tunnel_tpu_torch import models  # noqa: F401  (import order)
    from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build

    name = cs.card()
    print(name, flush=True)
    result = dict(card=name, plans=sweep(da._plane_lib(), da),
                  phases=phases(build_stamped(kernel_build), da))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
