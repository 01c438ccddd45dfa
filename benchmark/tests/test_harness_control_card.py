"""The control comes out as not correct, on the card, at each cell's own
size: a run whose judged tokens are the ones the reference computed with
float8 operands ranks first, one precision below the configuration's
bfloat16, goes through the run's own limits and its result line reads
``correct: false``, while the tokens served in that run pass them.  Each
cell runs as the benchmark runs it, in a process of its own.  Run on the card with

    python -m pytest -m cuda benchmark/tests/test_harness_control_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_the_program_passes(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 77), "--seconds", "8", "--trace", "0",
         "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    notes = next(json.loads(line) for line in out.stderr.splitlines()
                 if line.startswith('{"setup_marks_s"'))
    assert result["correct"] is False
    checks = result["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("logit_gap", "logit_gap_mean") if k in checks)
    assert checks["failed_requests"]["value"] == 0
    served = {"logit_gap": notes["served_gap"],
              "logit_gap_mean": notes["served_gap_mean"]}
    assert all(served[k] <= v["limit"] for k, v in checks.items()
               if k in served)
