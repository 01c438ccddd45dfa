"""The plain reference against the port's own forward pass at a tiny size
on the CPU, both in float32 on the same weights: dense with a sliding
window that bites, and the routed experts."""

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.models import transformer

from benchmark import check
from benchmark.arch import mistral
from benchmark.arch.mistral import Shape, logits_at
from benchmark.stack import model_config

TINY = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "vocab_size": 300}
CASES = {
    "dense-window": dict(TINY, preset="mistral-7b", sliding_window=7),
    "dense": dict(TINY, preset="mistral-7b", sliding_window=None),
    "moe": dict(TINY, preset="mixtral-8x7b", sliding_window=None,
                num_local_experts=4, num_experts_per_tok=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_port_in_float32(case):
    cfg = CASES[case]
    shape = Shape.from_config(cfg)
    params = mistral.draw(shape, 2**31 + 3, "cpu", dtype=torch.float32)
    mcfg = model_config(cfg)
    assert mcfg.n_experts == shape.num_local_experts
    if shape.sliding_window is not None:
        assert mcfg.window_pattern == "all"
    gen = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, 300, (n,), generator=gen) for n in (23, 9)]
    ref = logits_at(shape, params, seqs, [(0, 23), (0, 9)])
    for s, r in zip(seqs, ref):
        got, _, _ = transformer.prefill(
            mcfg, params, s[None], torch.ones((1, len(s)), dtype=torch.bool))
        assert torch.allclose(got[0], r, atol=2e-4, rtol=2e-4), case


def test_window_and_experts_change_the_answer():
    """The reference does apply the window and the routing: without them
    the logits differ."""
    seq = [torch.arange(23) % 300]
    want = [(0, 23)]
    a = CASES["dense-window"]
    params = mistral.draw(Shape.from_config(a), 5, "cpu", torch.float32)
    windowed = logits_at(Shape.from_config(a), params, seq, want)[0]
    full = logits_at(Shape.from_config(CASES["dense"]), params, seq, want)[0]
    assert torch.allclose(windowed[:7], full[:7], atol=1e-5)
    assert not torch.allclose(windowed[7:], full[7:], atol=1e-3)


def test_control_and_gap():
    cfg = CASES["dense"]
    shape = Shape.from_config(cfg)
    params = mistral.draw(shape, 11, "cpu", dtype=torch.bfloat16)
    prompt = list(range(5, 45))
    ref = logits_at(shape, params, [torch.tensor(prompt)], [(39, 40)])[0]
    best = int(ref.argmax())
    worst = int(ref.argmin())
    rec = {"prompt": prompt, "ids": [best], "c": 0, "s": 0, "turn": 0}
    out = check.served_gaps(mistral, shape, params, [rec], "cpu")
    assert out["logit_gap"] == 0.0 and out["tokens"] == 1.0
    # The control judges the float8 forward's first-ranked token instead.
    ctl = check.served_gaps(mistral, shape, params, [rec], "cpu", control=True)
    assert ctl["served_gap"] == 0.0 and ctl["tokens"] == 1.0
    low = logits_at(shape, params, [torch.tensor(prompt)], [(39, 40)],
                    precision="fp8")[0]
    assert ctl["logit_gap"] == pytest.approx(
        float(ref.max() - ref[0, int(low.argmax())]))
    rec["ids"] = [worst]
    bad = check.served_gaps(mistral, shape, params, [rec], "cpu")
    assert bad["logit_gap"] == pytest.approx(float(ref.max() - ref.min()))


def test_sample_takes_the_longest_and_enough_tokens():
    recs = [{"prompt": [0] * n, "ids": [1] * 10, "c": i, "s": 0, "turn": 0}
            for i, n in enumerate([5, 50, 500, 20, 7])]
    picked = check.sample(recs, 3, 25)
    assert picked[0]["c"] == 2 and len(picked) == 3
    assert [r["c"] for r in picked] == [r["c"] for r in check.sample(recs, 3, 25)]
    assert check.sample([], 3, 25) == []
