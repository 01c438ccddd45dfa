"""A whole run of the harness on the CPU at a tiny size, past its look for
a card: sound, it comes out correct; with the timed path broken underneath
(a served token altered where the engine produces it) it does not."""

import asyncio
import json
import time
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
CONFIG = {
    "preset": "tiny", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "sliding_window": None, "vocab_size": 512,
    "engine": {"num_slots": 4, "max_seq": 512, "dtype": "bfloat16",
               "mux": True, "prefix_cache": True, "conv_cache": True,
               "prefix_pool_blocks": 64, "ragged_prefill": True,
               "fused_decode_layer": True, "max_waiting": 64},
}
#: Each kind of number a configuration may compare: the widest gap, and the
#: mean gap alone (as a configuration whose widest gap does not separate).
LIMITS = {"widest": {"logit_gap": 0.25}, "mean": {"logit_gap_mean": 0.05}}
MIX = {"clients": 4, "warmup_s": 1, "strata": 8, "turns": 2,
       "documents": {"count": 2, "tokens": 64, "zipf_s": 1.1},
       "question": {"dist": "uniform", "min": 8, "max": 60},
       "output": {"dist": "uniform", "min": 4, "max": 12}}


def cell(tmp_path, limits):
    mix = tmp_path / "mix.json"
    mix.write_text(json.dumps(MIX))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = dict(CONFIG, check={"tokens": 48, "limits": limits})
    return {"name": "tiny", "chips": 1, "config": config,
            "mix_file": str(mix),
            "end_to_end": [(m["name"], m["unit"]) for m in bench["end_to_end"]],
            "per_layer": []}


def alter_tokens(engine):
    """Every decode burst hands the host its first step's tokens shifted by
    one id: served, but not what the model chose.  A row joins the batch
    at a burst's first step, so every request's second token is one."""
    inner = engine._decode_fn

    def decode(*args):
        toks, lps = inner(*args)
        toks = toks.clone()
        toks[:, 0] = (toks[:, 0] + 1) % 512
        return toks, lps

    engine._decode_fn = decode


@pytest.mark.parametrize("limits", sorted(LIMITS))
@pytest.mark.parametrize("fault", [None, "altered_token"])
def test_a_run_judges_what_was_served(tmp_path, fault, limits):
    out = asyncio.run(run.measure(
        cell(tmp_path, LIMITS[limits]), 2**31 + 5, 3.0, False, "cpu",
        tamper=alter_tokens if fault else None, t_start=time.monotonic()))
    res = out["result"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert out["checks"]["failed_requests"][0] == 0.0
    assert {"out_tok_s", "setup_s"} <= set(res["metrics"])
    (name,) = LIMITS[limits]
    gap, limit = out["checks"][name]
    if fault is None:
        assert res["correct"] and gap <= limit
    else:
        assert not res["correct"] and gap > limit
