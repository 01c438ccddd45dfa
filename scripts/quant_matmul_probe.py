#!/usr/bin/env python3
"""Where kernel 7's time goes: build variants of ``csrc/quant_matmul.cu``
and time each on the card at llama3-8b's projection shapes.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 scripts/quant_matmul_probe.py

Variants (each a copy of the source with edits that switch one part of
the work off, built by nvcc into ``build/quant_matmul_probe/``; only
``base`` computes the right product, the others run on stale tiles):
- ``base``: the source as it is;
- ``nocopy``: the producers issue no TMA copies of weights, scales or
  activations (KN layout; they still arrive on every barrier):
  dequantization, products and synchronization alone;
- ``nodequant``: no dequantization (decode: no A fragments built from the
  stage's bytes; prefill: no shared tile written);
- ``noproduct``: no wgmma issued;
- ``copyonly``: neither dequantization nor products: the copy pipeline and
  its barriers alone.

Each row is the device time per launch (torch.profiler, L2-cold: the
weights rotate over copies larger than 128 MB, as in ``chip_smoke.py``)
beside the least time the card could take; the card's name and power
limit head the output.  ``--out FILE`` also writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_NOCOPY = (
    ("      if (pl == 0) {  // the x tile, one TMA copy",
     "      if (pl == 0 && a.K < 0) {  // the x tile, one TMA copy"),
    ("        if (pl == 0) {\n          mbar_expect_tx(xfull + slot, blocks * XBLK);",
     "        if (pl == 0 && a.K < 0) {\n          mbar_expect_tx(xfull + slot, blocks * XBLK);"),
    ("    if (lane == 0) {\n      mbar_expect_tx(full, G::W_BYTES",
     "    if (lane == 0 && a.K < 0) {\n      mbar_expect_tx(full, G::W_BYTES"),
)
_NODEQUANT = (
    ("          a_frags<FORM, LAYOUT, G::W_ROW>(wst, srow, ks, wcol, g, c, af[b][j]);",
     "          if (a.K < 0) a_frags<FORM, LAYOUT, G::W_ROW>(wst, srow, ks, wcol, g, c, af[b][j]);"),
    ("    dequant_tile<FORM, LAYOUT>(a, wst,", "    if (a.K < 0) dequant_tile<FORM, LAYOUT>(a, wst,"),
)
_NOPRODUCT = (
    ("          if (ks < nks)\n            wgmma_rs(", "          if (ks < nks && a.K < 0)\n            wgmma_rs("),
    ("      if (ks < nks) {\n        const uint64_t da", "      if (ks < nks && a.K < 0) {\n        const uint64_t da"),
)
VARIANTS = {
    "base": (),
    "nocopy": _NOCOPY,
    "nodequant": _NODEQUANT,
    "noproduct": _NOPRODUCT,
    "copyonly": _NODEQUANT + _NOPRODUCT,
}
#: (name, N, K, rows): decode steps of llama3-8b and one ragged dispatch.
SHAPES = (("wq/wo", 4096, 4096, 17), ("wk/wv", 1024, 4096, 17),
          ("w_gate/w_up", 14336, 4096, 17), ("w_down", 4096, 14336, 17),
          ("lm_head", 128256, 4096, 17), ("wq/wo", 4096, 4096, 1024),
          ("w_gate/w_up", 14336, 4096, 1024))


def build(kernel_build) -> dict:
    """One nvcc per variant, started together; the loaded entry points."""
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
    fns = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{report}")
        fn = ctypes.CDLL(str(lib)).quant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the rows as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("quant_matmul_probe: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import p2p_llm_tunnel_tpu_torch.models  # noqa: F401  (ops import models.quant)
    from p2p_llm_tunnel_tpu_torch.ops import kernel_build
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    card = cs.card()
    print(card)
    fns = build(kernel_build)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for form in ("int8", "int4"):
        for name, n, k, m in SHAPES:
            wbytes = n * k // (2 if form == "int4" else 1)
            layers = max(2, -(-int(cs.L2_COLD_BYTES) // wbytes) + 1)
            q, s = cs.quant_weights(form, n, k, layers, "kn", 128, g)
            x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            kw = dict(in_dim=k, group_size=128) if form == "int4" else {}
            row = dict(form=form, shape=f"{name} N{n} K{k} M{m}",
                       plan=str(qm.launch_plan(m, n, k, form, "kn", 128)["grid"]))
            for vname, fn in fns.items():
                qm._FN = fn
                launch = cs.rotating(
                    lambda i: qm.quant_matmul(x, q[i], s[i], form=form, **kw), layers)
                row[vname] = cs.device_ms(launch, cs.K7_KERNELS, iters=20)
            row["bound_ms"] = cs.bound(wbytes + s[0].numel() * 4 + 2 * m * k + 2 * m * n,
                                       2 * m * n * k)[0]
            rows.append(row)
            print(f"{form} {row['shape']:<28} grid {row['plan']:<15} "
                  + " ".join(f"{v} {row[v]:.4f}" for v in VARIANTS)
                  + f"  bound {row['bound_ms']:.4f} ms", flush=True)
            del q, s
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}) + "\n")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
