"""Nothing the benchmark loads is JAX or the JAX package; the reference
loads nothing of the port; the client only the standard library.  Names
are compared whole, by their top-level part: the port's name begins with
the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "p2p_llm_tunnel_tpu"}


def imported(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_under_benchmark():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "p2p_llm_tunnel_tpu_torch" not in imported(f), f
        assert imported(f) <= {"__future__", "math", "dataclasses", "typing",
                               "torch", "benchmark"}, f


def test_client_is_standard_library_only():
    assert imported(HERE / "client.py") <= set(sys.stdlib_module_names)


def test_loaded_modules_have_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run as r, benchmark.stack, benchmark.check, "
            "benchmark.devtrace, benchmark.probes, benchmark.measures\n"
            "print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    monkeypatch.setitem(sys.modules, "p2p_llm_tunnel_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
