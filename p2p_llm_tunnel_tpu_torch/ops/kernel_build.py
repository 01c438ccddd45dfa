"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` at the root of the checkout, then loaded with
``ctypes``.  Libraries are keyed by a digest of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and a stale library is never loaded.

Nothing here runs at import time: the first launch of a kernel builds it
(``load``), and ``build`` compiles several sources at once, one ``nvcc``
process each, all started together (``chip_smoke.py`` builds every kernel
that way before it drives the engine).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: Every kernel of the port: library name -> source file in csrc/.
KERNEL_SOURCES: Dict[str, str] = {
    "flash_causal_attention": "flash_causal_attention.cu",
    "flash_decode_attention": "flash_decode_attention.cu",
    "flash_decode_attention_plane": "flash_decode_attention_plane.cu",
    "fused_decode_layer": "fused_decode_layer.cu",
    "fused_spec_decode_layer": "fused_spec_decode_layer.cu",
    "ragged_prefill_attention": "ragged_prefill_attention.cu",
    "quant_matmul": "quant_matmul.cu",
}

#: Dynamic shared memory one block may use on the card (H100: 227 KB); the
#: wrappers' launch plans are held to it.
MAX_SMEM_BYTES = 232448

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: name -> {"seconds": build wall time, "ptxas": compiler report}
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH.  Raises when none exists (no silent fallback)."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / KERNEL_SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc per source, started together; raises on any failure."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        report, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.monotonic() - t0, "ptxas": report}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error (0 = launched)."""
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} kernel launch failed: cuda error {rc} "
            f"({err(rc).decode(errors='replace')})"
        )
