"""The architectures the benchmark serves, one module each, found by name.

A configuration file names its architecture under ``"arch"``; a file
without the key is ``mistral``.  ``benchmark/arch/<name>.py`` holds the
whole model-specific side of the harness, and nothing outside this folder
names a weight leaf or a published key of one architecture:

- ``Shape``, a frozen dataclass of the published sizes, and
  ``shape(cfg) -> Shape`` from a configuration file;
- ``draw(shape, seed, device, dtype=torch.bfloat16)``: the weight tree from
  ``seed``, on ``device``, in the layout the port's engine takes
  (``InferenceEngine(params=...)``);
- ``logits_at(shape, params, seqs, want, precision="fp32")``: the plain
  reference (float32, TF32 off; ``"fp8"`` is the control), float32 logits
  ``[stop - start, vocab]`` at positions ``[start, stop)`` of each
  sequence, built from ``benchmark/reference/blocks.py``;
- ``model_fields(cfg)``: the port's ``ModelConfig`` fields that the file
  sets over the preset it names (``stack.model_config`` builds the
  config), so that the module itself imports nothing of the port;
- the work counts, summed over the layers where layers differ:
  ``matmul_flops_per_token(shape)``, ``head_flops(shape)``,
  ``attention_flops(shape, context)``, ``prefill_flops(shape, start,
  stop)``, ``decode_flops(shape, position)``; and the bytes of one layer's
  fused decode attention, the mean over the layers where they differ:
  ``decode_attention_bytes(shape, position)`` and ``burst_bytes(shape,
  rows)``.

The harness looks the module up once a run (``for_config``) and hands it to
whatever needs one of these.  A new architecture is a new module here and a
configuration file that names it.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict

ARCH_DIR = Path(__file__).resolve().parent
#: The architecture of a configuration file that names none.
DEFAULT = "mistral"


def load(name: str) -> ModuleType:
    """The module ``benchmark/arch/<name>.py``."""
    path = ARCH_DIR / f"{name}.py"
    if not name.isidentifier() or name.startswith("_") or not path.is_file():
        raise ValueError(f"unknown architecture {name!r}: no file {path}")
    return importlib.import_module(f"{__name__}.{name}")


def for_config(cfg: Dict) -> ModuleType:
    """The module of the architecture a configuration file names."""
    return load(cfg.get("arch", DEFAULT))
