"""Prompt-lookup speculative decoding in the port's engine, on the CPU
(``tiny``, fp32): speculation is a pure latency optimization — greedy
token streams are byte-identical with it on and off at every KV form,
fused or not, mux or not, and identical to the JAX engine's speculative
stream on the same weights (bridged, tie-free seed); seeded stochastic
rows accept nothing and sample their own stream; a logprobs request sends
the batch down the plain path; a stop id inside an accepted run drops the
surplus; the proposer's per-slot state never outlives its request."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.models.config import get_config
from p2p_llm_tunnel_tpu.models.transformer import init_params
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models.transformer import params_from_numpy
from p2p_llm_tunnel_tpu_torch.utils.flight import global_flight
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

#: Repetitive prompts: the n-gram proposer fires and verify bursts accept.
REP = list(b"the cat sat on the mat. the cat sat on the mat. the cat")
PROMPTS = [REP, REP[3:], REP[7:]]
WEIGHT_SEED = 3  # tie-free for these prompts


def _cfg(spec=True, **kw):
    base = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32",
                spec_ngram=3 if spec else 0, spec_k=4)
    base.update(kw)
    return EngineConfig(**base)


async def _collect(engine, prompt, max_new=40, **kw):
    return [ev async for ev in engine.generate(prompt, max_new_tokens=max_new,
                                                **kw)]


def _run(engine, requests):
    """Drive ``requests`` [(prompt, kwargs)] concurrently; returns each
    request's events and the spec counters of the run."""
    async def go():
        await engine.start()
        try:
            global_metrics.reset()
            outs = await asyncio.gather(*[_collect(engine, p, **kw)
                                          for p, kw in requests])
            return outs, {
                "proposed": global_metrics.counter("engine_spec_proposed_tokens_total"),
                "accepted": global_metrics.counter("engine_spec_accepted_tokens_total"),
                "hist": global_metrics.gauge("engine_spec_hist_entries"),
                "left": len(engine._spec_hist) + len(engine._spec_ema),
            }
        finally:
            await engine.stop()
    return asyncio.run(go())


def _ids(outs):
    return [[ev.token_id for ev in evs] for evs in outs]


GREEDY = [(p, dict(stop_ids=())) for p in PROMPTS]


@pytest.mark.parametrize("mux", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", ["none", "int8", "int4"])
def test_greedy_streams_identical_spec_on_and_off(kv, fused, mux):
    kw = dict(kv_quant=kv, fused_decode_layer=fused, mux=mux, prefix_cache=mux,
              conv_cache=mux)
    plain, _ = _run(InferenceEngine(engine_cfg=_cfg(False, **kw), device="cpu"),
                    GREEDY)
    spec, c = _run(InferenceEngine(engine_cfg=_cfg(spec_k_max=8, **kw),
                                   device="cpu"), GREEDY)
    assert _ids(spec) == _ids(plain)
    assert c["proposed"] > 0 and c["accepted"] > 0
    assert c["hist"] == 0 and c["left"] == 0


@pytest.mark.parametrize("kv", ["none", "int4"])
def test_spec_stream_matches_the_jax_engine(kv):
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    kw = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32",
              spec_ngram=3, spec_k=4, kv_quant=kv)
    want, _ = _run(JInferenceEngine(engine_cfg=JEngineConfig(**kw), params=jp),
                   GREEDY)
    got, c = _run(InferenceEngine(engine_cfg=EngineConfig(**kw), params=tp,
                                  device="cpu"), GREEDY)
    assert _ids(got) == _ids(want)
    assert c["proposed"] > 0


def test_seeded_stochastic_rows_identical_spec_on_and_off():
    """A seeded stochastic request beside greedy ones: it accepts nothing
    and samples position pos + 1 from its own (seed, position) stream, as a
    plain decode step does."""
    reqs = GREEDY[:2] + [(REP, dict(stop_ids=(), temperature=0.8, top_k=20,
                                    seed=1234))]
    plain, _ = _run(InferenceEngine(engine_cfg=_cfg(False), device="cpu"), reqs)
    spec, c = _run(InferenceEngine(engine_cfg=_cfg(), device="cpu"), reqs)
    assert _ids(spec) == _ids(plain)
    assert c["proposed"] > 0


def test_logprobs_request_takes_the_plain_path():
    reqs = [(REP, dict(stop_ids=(), logprobs=3))]
    plain, _ = _run(InferenceEngine(engine_cfg=_cfg(False), device="cpu"), reqs)
    spec, c = _run(InferenceEngine(engine_cfg=_cfg(), device="cpu"), reqs)
    assert c["proposed"] == 0
    assert _ids(spec) == _ids(plain)
    for got, want in zip(spec[0], plain[0]):
        assert got.logprob is not None and got.top_logprobs
        assert got.logprob == pytest.approx(want.logprob, abs=1e-5)


def test_stop_id_inside_an_accepted_run_drops_the_surplus():
    """A verify burst whose accepted run holds the stop id: the stream ends
    on it and the burst's later tokens are never emitted."""
    engine = InferenceEngine(engine_cfg=_cfg(), device="cpu")

    def verify(tokens, positions, samp, kv_view):
        b = tokens.shape[0]
        emitted = torch.tensor([[11, 99, 12, 13, 14]] * b, dtype=torch.int32)
        return emitted, torch.full((b,), 5)

    engine._spec_verify_fn = verify
    (events,), c = _run(engine, [(REP, dict(stop_ids=(99,), max_new=30))])
    assert [ev.token_id for ev in events][1:] == [11, 99]
    assert events[-1].finish_reason == "stop"
    assert c["left"] == 0


def test_stop_id_streams_identical_spec_on_and_off():
    full, _ = _run(InferenceEngine(engine_cfg=_cfg(False), device="cpu"),
                   GREEDY[:1])
    toks = _ids(full)[0]
    stop = toks[23]  # reached after verify bursts accepted proposals
    reqs = [(REP, dict(stop_ids=(stop,)))]
    plain, _ = _run(InferenceEngine(engine_cfg=_cfg(False), device="cpu"), reqs)
    spec, c = _run(InferenceEngine(engine_cfg=_cfg(), device="cpu"), reqs)
    assert _ids(spec) == _ids(plain) == [toks[:toks.index(stop) + 1]]
    assert spec[0][-1].finish_reason == "stop"
    assert c["accepted"] > 0 and c["left"] == 0


def test_warmup_plan_holds_the_adaptive_spec_ladder():
    engine = InferenceEngine(engine_cfg=_cfg(spec_k_max=8), device="cpu")
    spec = [shape for kind, shape in engine.warmup_plan() if kind == "spec"]
    views = sorted({v for v, _ in spec})
    assert views == engine._view_buckets()
    assert spec == [(v, k) for v in views for k in (1, 2, 4, 8)]
    fixed = InferenceEngine(engine_cfg=_cfg(), device="cpu")
    assert {k for kind, (_, k) in
            [(kind, s) for kind, s in fixed.warmup_plan() if kind == "spec"]} == {4}
    assert not [s for kind, s in InferenceEngine(
        engine_cfg=_cfg(False), device="cpu").warmup_plan() if kind == "spec"]


def test_spec_composes_with_the_serve_defaults_without_fences():
    engine = InferenceEngine(engine_cfg=_cfg(
        spec_k_max=8, kv_quant="int4", fused_decode_layer=True, mux=True,
        prefix_cache=True, conv_cache=True), device="cpu")
    assert engine.config_fences == []
    assert engine.ecfg.spec_ngram == 3 and engine.mcfg.fused_decode_layer


def test_spec_pads_the_view_and_records_flight_fields():
    engine = InferenceEngine(engine_cfg=_cfg(spec_k_max=8), device="cpu")
    plain = InferenceEngine(engine_cfg=_cfg(False), device="cpu")
    for e in (engine, plain):
        e._active_mask[0] = True
        e._positions[0] = 128 - 2 * e.ecfg.decode_steps - 2
    assert plain._kv_view_bucket() == 128 and engine._kv_view_bucket() == 256
    global_flight.reset()
    _run(InferenceEngine(engine_cfg=_cfg(), device="cpu"), GREEDY[:1])
    recs = [r for r in global_flight.records() if r.get("spec_k")]
    assert recs and all(r["spec_k"] == 4 and r["spec_proposed"] == 4 for r in recs)
    assert sum(r["spec_accepted"] for r in recs) > 0


def test_cancelled_request_releases_its_proposer_state():
    async def go():
        engine = InferenceEngine(engine_cfg=_cfg(), device="cpu")
        await engine.start()
        try:
            gen = engine.generate(REP, max_new_tokens=200, stop_ids=())
            n = 0
            async for _ in gen:
                n += 1
                if n == 12:
                    break
            await gen.aclose()
            return len(engine._spec_hist), global_metrics.gauge(
                "engine_spec_hist_entries")
        finally:
            await engine.stop()
    assert asyncio.run(go()) == (0, 0)
