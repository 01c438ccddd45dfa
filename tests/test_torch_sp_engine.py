"""The port's sequence parallelism (``--sp``, ``--sp-mode``) end to end
against the JAX package, on the CPU.

- Model level: spawned gloo ranks (``torch_tp_ranks``) run ``prefill``
  (whole-sequence logits and K/V) and ``prefill_into_cache`` (the last
  logits and the K/V each rank writes into its replicated cache) on JAX's
  fp32 weights, each rank carrying its own sequence block.  At sp 2
  (ring and Ulysses on tiny, Ulysses on tiny-gemma with its sliding window
  and softcaps) and at tp 2 x sp 2 over four ranks (ring on tiny, Ulysses
  on tiny with 4 kv heads), against JAX's ``prefill`` and
  ``prefill_into_cache`` on a ``cpu_devices`` mesh of the same shape:
  within 1e-4 (fp32; the two differ in summation order only).
- Engines: sp 2 engines of both modes (rank 0 serving through the port's
  tunnel stack while rank 1 replays) stream byte-identical greedy ids to
  the JAX engine at sp 2 on the same fp32 weights and traffic (weight seed
  3, tie-free as in tests/test_torch_engine.py), with JAX's
  ``config_fences`` and ``mcfg.sp_mode``; rank 1 samples what rank 0
  samples.  The fences of a flag set that trips every sp fence (and, at
  tp 2 x sp 2, the sp reason before the tp one) equal JAX's.
- The CLI: ``serve --sp 2 --sp-mode ulysses`` on one host makes this
  process rank 0, starts rank 1 itself, and serves the ids a one-process
  engine serves, with the fences of the JAX engine the JAX CLI's flags
  build.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p2p_llm_tunnel_tpu import cli as j_cli
from p2p_llm_tunnel_tpu.endpoints.proxy import run_proxy as j_run_proxy
from p2p_llm_tunnel_tpu.endpoints.serve import run_serve as j_run_serve
from p2p_llm_tunnel_tpu.engine.api import engine_backend as j_engine_backend
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.engine.tokenizer import NumericTokenizer as JNumeric
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu.parallel import shard_kv_cache as j_shard_kv_cache
from p2p_llm_tunnel_tpu.parallel import shard_params as j_shard_params
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu_torch import cli

from torch_tp_ranks import conversations, run_ranks, tunnel_stack

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 512
WEIGHT_SEED = 3  # tie-free at fp32 for the traffic below

#: model case -> (tp, sp, preset, config overrides, T, lengths)
MODEL_CASES = {
    "ring": (1, 2, "tiny", dict(sp_mode="ring"), 16, (16, 9)),
    "ulysses": (1, 2, "tiny", dict(sp_mode="ulysses"), 16, (16, 9)),
    "ulysses-gemma": (1, 2, "tiny-gemma", dict(sp_mode="ulysses"), 32, (32, 19)),
    "ring-tp2sp2": (2, 2, "tiny", dict(sp_mode="ring"), 16, (11, 16)),
    "ulysses-tp2sp2": (2, 2, "tiny", dict(sp_mode="ulysses", n_kv_heads=4), 32,
                       (32, 21)),
}

PLAIN = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32",
             decode_steps=4, tp=1, sp=2)
DEFAULTS = dict(PLAIN, mux=True, prefix_cache=True, conv_cache=True,
                prefill_chunk=32)
#: engine job -> its EngineConfig kwargs (both packages).
JOBS = {
    "ring-plain": dict(PLAIN, sp_mode="ring"),
    "ring-defaults": dict(DEFAULTS, sp_mode="ring"),
    "ulysses-defaults": dict(DEFAULTS, sp_mode="ulysses", ragged_prefill=True),
}
#: flag sets that trip every sp fence -> (world, EngineConfig kwargs).
FENCES = {
    "sp2": (2, dict(DEFAULTS, ragged_prefill=True, kv_quant="int4",
                    spill_pages=8, role="prefill")),
    "tp2sp2": (4, dict(DEFAULTS, tp=2, ragged_prefill=True)),
}


def _model_case(name):
    tp, sp, preset, over, t, lengths = MODEL_CASES[name]
    jcfg = j_get_config(preset, vocab_size=VOCAB, **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, VOCAB, size=(len(lengths), t)).astype(np.int32)
    case = dict(tp=tp, sp=sp, preset=preset, overrides=dict(over, vocab_size=VOCAB),
                params=jax.tree.map(np.asarray, jp), tokens=tokens,
                lengths=np.array(lengths, np.int32), slots=3, seq=48,
                slot_idx=np.array([2, 0], np.int32)[:len(lengths)])
    return case, (jcfg, jp)


@pytest.fixture(scope="module")
def weights():
    """The JAX fp32 tree both packages' engines serve."""
    return jt.init_params(j_get_config("tiny", vocab_size=VOCAB),
                          jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """One spawn of two ranks (sp 2: model cases, engine jobs, fences) and
    one of four (tp 2 x sp 2: model cases, fences)."""
    out = {}
    for world in (2, 4):
        cases = {name: _model_case(name)[0] for name, spec in MODEL_CASES.items()
                 if spec[0] * spec[1] == world}
        fences = {name: kw for name, (w, kw) in FENCES.items() if w == world}
        suite = [("sp_model", cases),
                 ("engine_fences", dict(vocab=VOCAB, configs=fences))]
        if world == 2:
            suite.append(("engine_streams", dict(
                vocab=VOCAB, weights={WEIGHT_SEED: jax.tree.map(np.asarray, weights)},
                jobs={name: dict(engine=kw, weights=WEIGHT_SEED)
                      for name, kw in JOBS.items()})))
        out[world] = run_ranks("several", world, suite,
                               tmp_path_factory.mktemp(f"sp{world}"), timeout_s=400.0)
    return out


def _model(runs, name):
    tp, sp = MODEL_CASES[name][:2]
    return [r[0][name] for r in runs[tp * sp]]


@pytest.fixture(scope="module")
def jax_model(cpu_devices):
    """name -> JAX's outputs for that model case (computed once)."""
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _jax_model(name, cpu_devices)
        return memo[name]

    return get


def _jax_model(name, cpu_devices):
    case, (jcfg, jp) = _model_case(name)
    tp, sp = case["tp"], case["sp"]
    mesh = j_make_mesh(tp=tp, sp=sp, devices=cpu_devices[:tp * sp])
    cache = jt.init_kv_cache(jcfg, case["slots"], case["seq"], jnp.float32)
    if tp > 1:
        jp = j_shard_params(jp, jcfg, mesh)
        cache = j_shard_kv_cache(cache, mesh)
    tokens, lengths = jnp.asarray(case["tokens"]), jnp.asarray(case["lengths"])
    valid = jnp.arange(tokens.shape[1])[None, :] < lengths[:, None]
    logits, ks, vs = jax.jit(lambda p: jt.prefill(jcfg, p, tokens, valid,
                                                  mesh=mesh))(jp)
    last, cache = jax.jit(lambda p, c: jt.prefill_into_cache(
        jcfg, p, tokens, lengths, c, jnp.asarray(case["slot_idx"]), mesh=mesh))(jp, cache)
    return {k: np.asarray(v) for k, v in dict(
        logits=logits, ks=ks, vs=vs, last=last, k=cache["k"], v=cache["v"]).items()}


def _heads(ranks_out, key, tp, axis):
    """A per-rank tp shard array joined over the tp ranks of sp block 0."""
    return np.concatenate([ranks_out[t][key] for t in range(tp)], axis=axis)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_prefill_logits_and_kv_match_jax_sp_mesh(name, runs, jax_model):
    tp = MODEL_CASES[name][0]
    want = jax_model(name)
    ranks = _model(runs, name)
    for r in ranks:  # every rank holds the whole sequence's logits
        np.testing.assert_allclose(r["logits"], want["logits"], **TOL)
        np.testing.assert_allclose(r["last"], want["last"], **TOL)
    for key in ("ks", "vs"):  # [L, B, T, K, D]
        np.testing.assert_allclose(_heads(ranks, key, tp, 3), want[key], **TOL)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_cache_written_at_sp_matches_jax(name, runs, jax_model):
    """Each rank's cache (replicated over sp, its heads under tp) holds the
    K/V JAX's prefill_into_cache writes, in the prompts' slots."""
    tp, sp = MODEL_CASES[name][:2]
    case, _ = _model_case(name)
    want = jax_model(name)
    ranks = _model(runs, name)
    t = case["tokens"].shape[1]
    for key in ("k", "v"):
        for s in range(sp):  # sp ranks hold the same cache
            got = np.concatenate([ranks[s * tp + h][key] for h in range(tp)], axis=3)
            for slot in case["slot_idx"]:
                np.testing.assert_allclose(got[:, slot, :t], want[key][:, slot, :t],
                                           **TOL)


def _jax_streams(jp, kw):
    engine = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                              engine_cfg=JEngineConfig(**kw), params=jp,
                              tokenizer=JNumeric(VOCAB))

    async def drive():
        async with tunnel_stack(engine, j_engine_backend, j_run_serve, j_run_proxy,
                                j_loopback_pair) as base:
            return await conversations(base)

    return asyncio.run(asyncio.wait_for(drive(), 300)), engine


@pytest.mark.parametrize("job", sorted(JOBS))
def test_sp2_streams_match_the_jax_engine_at_sp2(job, runs, weights, cpu_devices):
    got = runs[2][0][2][job]
    want, jengine = _jax_streams(weights, JOBS[job])
    assert [list(ids) for ids, _ in got["streams"]] == [list(ids) for ids, _ in want]
    assert [fin for _, fin in got["streams"]] == [fin for _, fin in want]
    assert all(len(ids) > 0 for ids, _ in got["streams"])
    assert got["fences"] == jengine.config_fences
    assert got["sp_mode"] == jengine.mcfg.sp_mode == JOBS[job]["sp_mode"]
    assert got["mesh"] == ({"dp": 1, "ep": 1, "tp": 1, "sp": 2}, 0)
    assert got["kv_shape"][3] == 2  # the cache is replicated over sp


@pytest.mark.parametrize("job", sorted(JOBS))
def test_sp_follower_samples_what_rank0_samples(job, runs):
    lead, follower = runs[2][0][2][job]["ids"], runs[2][1][2][job]["ids"]
    assert lead and follower == lead
    assert {"_prefill_fn", "_decode_fn"} <= {name for name, _ in lead}
    assert runs[2][1][2][job]["ops"] >= len(lead)


@pytest.mark.parametrize("name", sorted(FENCES))
def test_sp_fences_carry_the_jax_reasons_in_its_order(name, runs, cpu_devices):
    world, kw = FENCES[name]
    j = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                         engine_cfg=JEngineConfig(**kw))
    fences, ecfg = runs[world][0][1][name]
    assert fences == j.config_fences
    assert ecfg == {k: getattr(j.ecfg, k) for k in ecfg}
    knobs = [f["knob"] for f in fences]
    assert knobs[:3] == ["prefill_chunk", "ragged_prefill", "prefix_cache"]
    assert "sp>1" in fences[1]["reason"]


def test_serve_sp2_starts_its_follower_rank(tmp_path, monkeypatch, cpu_devices):
    """``serve --sp 2 --sp-mode ulysses`` with no --coordinator: this
    process is rank 0 and starts rank 1 as a local process; the greedy ids
    equal a one-process engine's on the same seed-0 weights, and the
    engine is the one the JAX CLI's flags build (fences, sp_mode)."""
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    monkeypatch.setattr(pd, "local_rendezvous",
                        lambda: f"file://{tmp_path}/rendezvous")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tiny = ["--model", "tiny", "--slots", "2", "--max-seq", "128", "--dtype",
            "float32", "--device", "cpu"]
    flags = ["--sp", "2", "--sp-mode", "ulysses"]

    async def ids(args):
        backend = await cli._engine_backend(args)
        engine = backend.kv_import.__self__
        try:
            out = [ev.token_id async for ev in engine.generate(
                list(b"hello sequence parallel"), max_new_tokens=6, stop_ids=())]
            return out, engine
        finally:
            await engine.stop()
            cli._BACKEND = None

    try:
        got, engine = asyncio.run(asyncio.wait_for(ids(cli.build_parser().parse_args(
            ["serve", "--backend", "gpu", "--room", "r"] + flags + tiny)), 120))
        followers = cli._FOLLOWERS
        assert (engine.mesh.sp, engine.mesh.tp, engine._spmd.rank) == (2, 1, 0)
        assert len(followers.procs) == 1
        followers.close(timeout_s=30.0)
        assert not followers.alive() and followers.failed() == []
    finally:
        pd.shutdown_distributed()
        if cli._FOLLOWERS is not None:
            cli._FOLLOWERS.close(timeout_s=5.0)
            cli._FOLLOWERS = None
    want, _ = asyncio.run(ids(cli.build_parser().parse_args(
        ["serve", "--backend", "gpu", "--room", "r"] + tiny)))
    assert got == want and len(got) == 6
    jargs = j_cli.build_parser().parse_args(
        ["serve", "--backend", "tpu", "--room", "r"] + flags)
    ecfg = cli._engine_config(cli.build_parser().parse_args(
        ["serve", "--backend", "gpu", "--room", "r"] + flags + tiny))
    assert (ecfg.sp, ecfg.sp_mode) == (jargs.sp, jargs.sp_mode)
    jengine = JInferenceEngine(engine_cfg=JEngineConfig(**dataclasses.asdict(ecfg)))
    assert engine.config_fences == jengine.config_fences
    assert engine.mcfg.sp_mode == jengine.mcfg.sp_mode == "ulysses"


def test_prefill_width_must_divide_over_sp():
    """Nothing is padded: a wave whose width does not divide over sp is
    refused before any exchange."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh

    cfg = get_config("tiny", vocab_size=VOCAB)
    params = tt.init_params(cfg, 0, torch.float32, "cpu")
    with pytest.raises(ValueError, match="T=15, sp=2"):
        tt.prefill(cfg, params, torch.zeros((1, 15), dtype=torch.long),
                   torch.ones((1, 15), dtype=torch.bool), mesh=Mesh(sp=2))
