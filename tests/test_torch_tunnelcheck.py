"""tunnelcheck's page-pin rules over the port: TC18 (no KV page bytes
spliced into a pool without ``verify_page_pin``) and TC20 (the same,
interprocedurally, for page bytes reaching a splice, a tier write or a
tunnel send).  Both rules scope themselves to the JAX package's path
(``rules_tierpin.SCOPE_PART``); here that scope is pointed at
``p2p_llm_tunnel_tpu_torch/`` so the port's spill tier, snapshots and
KV_PAGES paths are held to the contract the JAX package is.  A fixture
with an unchecked splice under the port's path shows the retargeted
rules see the port's files."""

from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

from tools.tunnelcheck import run_paths, rules_tierpin

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "p2p_llm_tunnel_tpu_torch/"


@pytest.fixture
def port_scope(monkeypatch):
    monkeypatch.setattr(rules_tierpin, "SCOPE_PART", PORT)


def test_port_passes_tc18_and_tc20(port_scope):
    active, _waived = run_paths([REPO_ROOT / PORT], rules=["TC18", "TC20"])
    assert active == [], "\n".join(v.render(REPO_ROOT) for v in active)


def test_unchecked_splice_under_the_port_path_is_flagged(port_scope, tmp_path):
    f = tmp_path / PORT / "engine" / "splice.py"
    f.parent.mkdir(parents=True)
    f.write_text(textwrap.dedent("""
        def copy_in(self, items):
            for key, idx, page in items:
                self._page_in_op(self._pool, idx, page.payload)

        def copy_in_checked(self, items):
            for key, idx, page in items:
                payload = verify_page_pin(page.payload, page.meta, self._spill_meta)
                self._page_in_op(self._pool, idx, payload)
    """))
    active, _waived = run_paths([f], rules=["TC18", "TC20"])
    assert sorted({(v.rule, v.line) for v in active}) == [("TC18", 4), ("TC20", 4)]
