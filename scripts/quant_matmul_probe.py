#!/usr/bin/env python3
"""Where kernel 7's time goes: build variants of ``csrc/quant_matmul.cu``
and time each on the card at llama3-8b's projection shapes.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 scripts/quant_matmul_probe.py

Variants (each a copy of the source with one edit, built by nvcc into
``build/quant_matmul_probe/``; only ``base`` computes the right product):
- ``base``: the source as it is;
- ``noload``: the slab loop issues no copies after the prologue (the
  products and dequantization alone, on stale tiles);
- ``noproduct``: no dequantization or products (the copy pipeline alone);
- ``stages8``: the decode plan with 8 stages instead of 4 (more bytes in
  flight, fewer blocks per SM);
- ``bn32``: the decode plan with 32-column tiles (twice the blocks).

Each row is the device time per launch (torch.profiler, L2-cold: the
weights rotate over copies larger than 128 MB, as in ``chip_smoke.py``)
beside the least time the card could take; the card's name and power
limit head the output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SMALL = "launch<FORM, LAYOUT, 32, 64, 128, 4, 4>"
VARIANTS = {
    "base": (),
    "noload": (("    if (nxt < nslabs)\n      load_stage",
                "    if (false)\n      load_stage"),),
    "noproduct": (("for (int kk = 0; kk < KS / WARPS_K; ++kk) {",
                   "for (int kk = 0; kk < 0; ++kk) {"),),
    "stages8": ((SMALL, "launch<FORM, LAYOUT, 32, 64, 128, 4, 8>"),),
    "bn32": ((SMALL, "launch<FORM, LAYOUT, 32, 32, 128, 4, 4>"),),
}
#: (name, N, K, rows): decode steps of llama3-8b and one ragged dispatch.
SHAPES = (("wq/wo", 4096, 4096, 17), ("wk/wv", 1024, 4096, 17),
          ("w_gate/w_up", 14336, 4096, 17), ("w_down", 4096, 14336, 17),
          ("lm_head", 128256, 4096, 17), ("w_gate/w_up", 14336, 4096, 1024))


def build(kernel_build) -> dict:
    """One nvcc per variant, started together; the loaded libraries."""
    src = (kernel_build.CSRC_DIR / "quant_matmul.cu").read_text()
    out_dir = ROOT / "build" / "quant_matmul_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS,
             "-I", str(kernel_build.CSRC_DIR), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{report}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.quant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        libs[name] = cdll
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("quant_matmul_probe: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import p2p_llm_tunnel_tpu_torch.models  # noqa: F401  (ops import models.quant)
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    print(cs.card())
    libs = build(kernel_build)
    g = torch.Generator(device="cuda").manual_seed(0)
    for form in ("int8", "int4"):
        for name, n, k, m in SHAPES:
            wbytes = n * k // (2 if form == "int4" else 1)
            layers = max(2, -(-int(cs.L2_COLD_BYTES) // wbytes) + 1)
            q, s = cs.quant_weights(form, n, k, layers, "kn", 128, g)
            x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            kw = dict(in_dim=k, group_size=128) if form == "int4" else {}
            line = f"{form} {name:<12} N{n:<6} K{k:<5} M{m:<5}"
            for vname, lib in libs.items():
                if m > qm.SMALL_MAX_M and vname in ("stages8", "bn32"):
                    continue  # decode-plan variants
                qm._lib = lambda lib=lib: lib
                launch = cs.rotating(
                    lambda i: qm.quant_matmul(x, q[i], s[i], form=form, **kw), layers)
                line += f" {vname} {cs.device_ms(launch, 'quant_matmul_kernel', iters=20):.4f}"
            bound = cs.bound(wbytes + s[0].numel() * 4 + 2 * m * k + 2 * m * n,
                             2 * m * n * k)[0]
            print(f"{line}  bound {bound:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
