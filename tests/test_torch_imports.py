"""The PyTorch port imports neither JAX nor the JAX package.

One fresh interpreter imports every module of ``p2p_llm_tunnel_tpu_torch``
in turn and records, after each import, which forbidden modules are
loaded: ``jax`` (or ``jax.*``) and the reference package
``p2p_llm_tunnel_tpu`` (or ``p2p_llm_tunnel_tpu.*``), matched by exact
name or dotted prefix — a plain prefix test would also match
``p2p_llm_tunnel_tpu_torch``.  The module list comes from the package's
files, so a new module is checked without editing this test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "p2p_llm_tunnel_tpu_torch"

MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts[:-1]
             if p.name == "__init__.py"
             else p.relative_to(REPO).with_suffix("").parts)
    for p in PKG.rglob("*.py")
)

_PROBE = """
import importlib, json, sys

def forbidden():
    return sorted(
        n for n in sys.modules
        if n == "jax" or n.startswith("jax.")
        or n == "p2p_llm_tunnel_tpu" or n.startswith("p2p_llm_tunnel_tpu.")
    )

report = {"_startup": forbidden()}
for name in sys.argv[1:]:
    importlib.import_module(name)
    report[name] = forbidden()
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def report():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_probe_starts_clean(report):
    assert report["_startup"] == []
    assert "p2p_llm_tunnel_tpu_torch.engine.engine" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(report, module):
    assert report[module] == [], f"{module} loaded {report[module]}"
