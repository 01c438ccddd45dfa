"""The port's data parallelism (``--dp-dcn``: a mesh's ``dp`` axis splitting
the engine's slots, ``parallel/data_parallel``) against the JAX package,
on the CPU.

- Mesh groups: for every ``(dp, ep, tp, sp)`` shape of four ranks, each
  spawned gloo rank's coordinates and the ranks of its group on every axis
  equal the JAX mesh's device layout on the 8 virtual CPU devices (a rank
  is the device of the same index: processes are dp-outermost, as the
  hybrid mesh lays out hosts).
- Model level, dp 2 x tp 2 over four ranks: one prefill wave whose rows'
  slots fall on both dp ranks (each rank runs the rows of its own slots
  into its cache block) and one decode step over each rank's rows, on
  JAX's fp32 weights, against ``prefill_into_cache`` and ``decode_step``
  of JAX's ``make_mesh(tp=2, dp=2)`` within 2e-4 (the tolerance of
  tests/test_parallel.py: summation order only), at kv none, int8 and
  int4.  Each rank's cache block is bitwise the same rows of the dp 1
  cache its tp group writes from the whole wave — the int8 and int4 code
  bytes and their scales included.
- Engines through the CLI's ``--dp-dcn 2 --coordinator`` flags over two
  ranks (rank 0 serving the conversations through the port's tunnel,
  rank 1 replaying): the greedy streams of the plain loop, of the serve
  defaults + ``--ragged-prefill`` and of ``--kv-quant int4
  --fused-decode-layer --spec-ngram 3`` are byte-identical to the JAX
  engine's on the same fp32 weights (weight seed 3, tie-free) and config,
  each rank holding half the cache's rows.  Where dp does not divide
  ``num_slots + 1`` both packages refuse: JAX's ``device_put`` of the
  cache on a dp 2 mesh of the virtual devices and the port's engine raise
  ``ValueError``.  The fences of the pool's page I/O (``--spill-pages``,
  ``--role``) are the JAX engine's under its dp 2 mesh, with the same
  reasons.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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

TOL = dict(atol=2e-4, rtol=2e-4)
VOCAB = 512
WEIGHT_SEED = 3  # tie-free at fp32 for the traffic below
AXES = ("dp", "ep", "tp", "sp")
#: Every (dp, ep, tp, sp) shape of four ranks.
SHAPES = [s for s in np.ndindex(5, 5, 5, 5)
          if np.prod(s) == 4 and all(n in (1, 2, 4) for n in s)]
KV_FORMS = ("none", "int8", "int4")
COMMON = ["--slots", "3", "--max-seq", "256", "--decode-steps", "4",
          "--dp-dcn", "2"]
#: engine job -> its serve flags after the --coordinator ones.
JOBS = {
    "plain": COMMON + ["--no-mux", "--no-prefix-cache", "--no-conv-cache"],
    "defaults-ragged": COMMON + ["--ragged-prefill"],
    "int4-fused-spec": COMMON + ["--kv-quant", "int4", "--fused-decode-layer",
                                 "--spec-ngram", "3"],
    "fences": COMMON + ["--spill-pages", "8", "--role", "prefill"],
    "slots-8": ["--slots", "8", "--max-seq", "256", "--dp-dcn", "2"],
}


def _model_case(form):
    jcfg = j_get_config("tiny", vocab_size=VOCAB, n_kv_heads=4)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.default_rng(5)
    return dict(
        tp=2, dp=2, preset="tiny", overrides=dict(vocab_size=VOCAB, n_kv_heads=4),
        params=jax.tree.map(np.asarray, jp), slots=4, seq=32,
        kv_quant=None if form == "none" else form,
        tokens=rng.integers(0, VOCAB, size=(3, 12)).astype(np.int32),
        lengths=np.array([12, 7, 10], np.int32),
        slot_idx=np.array([3, 0, 2], np.int32),
        dec_tokens=rng.integers(0, VOCAB, size=4).astype(np.int32),
        dec_pos=np.array([7, 40, 10, 12], np.int32),
    ), (jcfg, jp)


@pytest.fixture(scope="module")
def weights():
    """The JAX fp32 tree both packages' engines serve."""
    return jt.init_params(j_get_config("tiny", vocab_size=VOCAB),
                          jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """One spawn of four ranks (mesh groups, dp 2 x tp 2 model cases) and
    one of two (the CLI's --dp-dcn 2 engines)."""
    four = run_ranks("several", 4, [
        ("mesh_groups", SHAPES),
        ("dp_model", {f: _model_case(f)[0] for f in KV_FORMS}),
    ], tmp_path_factory.mktemp("dp4"), timeout_s=300.0)
    two = run_ranks("dp_cli_streams", 2, dict(
        vocab=VOCAB, weights=jax.tree.map(np.asarray, weights), jobs=JOBS,
        construct_only=("fences", "slots-8")),
        tmp_path_factory.mktemp("dp2"), timeout_s=300.0)
    return four, two


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_groups_follow_the_jax_device_layout(shape, runs, cpu_devices):
    dp, ep, tp, sp = shape
    jm = j_make_mesh(tp=tp, dp=dp, sp=sp, ep=ep, devices=cpu_devices[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)  # axes (dp, ep, tp, sp)
    base = cpu_devices[0].id
    for rank, out in enumerate(runs[0]):
        got = out[0][shape]
        where = tuple(int(c[0]) for c in np.nonzero(ids == base + rank))
        for i, axis in enumerate(AXES):
            coord, ranks = got[axis]
            assert coord == where[i]
            line = ids[where[:i] + (slice(None),) + where[i + 1:]] - base
            assert ranks == (None if shape[i] == 1 else list(line))


def _jax_dp_model(form, cpu_devices):
    case, (jcfg, jp) = _model_case(form)
    mesh = j_make_mesh(tp=2, dp=2, devices=cpu_devices[:4])
    quant = None if form == "none" else form
    cache = j_shard_kv_cache(jt.init_kv_cache(jcfg, case["slots"], case["seq"],
                                              jnp.float32, quant=quant), mesh)
    jp = j_shard_params(jp, jcfg, mesh)
    tokens, lengths = jnp.asarray(case["tokens"]), jnp.asarray(case["lengths"])
    last, cache = jax.jit(lambda p, c: jt.prefill_into_cache(
        jcfg, p, tokens, lengths, c, jnp.asarray(case["slot_idx"])))(jp, cache)
    logits, _ = jax.jit(lambda p, c: jt.decode_step(
        jcfg, p, c, jnp.asarray(case["dec_tokens"]), jnp.asarray(case["dec_pos"])))(
            jp, cache)
    return case, np.asarray(last), np.asarray(logits)


@pytest.mark.parametrize("form", KV_FORMS)
def test_dp2_tp2_prefill_and_decode_match_jax(form, runs, cpu_devices):
    case, last, logits = _jax_dp_model(form, cpu_devices)
    seen = set()
    for out in runs[0]:
        got = out[1][form]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["last"], last[got["idx"]], **TOL)
        np.testing.assert_allclose(got["logits"], logits[lo:hi], **TOL)
        np.testing.assert_allclose(got["last_ref"], last, **TOL)
        np.testing.assert_allclose(got["logits_ref"], logits, **TOL)
        seen.update(got["idx"].tolist())
    assert seen == set(range(len(case["slot_idx"])))  # every row ran once


@pytest.mark.parametrize("form", KV_FORMS)
def test_dp_cache_block_is_the_dp1_rows_bitwise(form, runs):
    for out in runs[0]:
        got = out[1][form]
        assert sorted(got["cache"]) == sorted(got["ref_rows"])
        assert set(got["cache"]) == ({"k", "v"} if form == "none" else
                                     {"k", "v", "k_scale", "v_scale"})
        for key, block in got["cache"].items():
            assert block.shape == got["ref_rows"][key].shape
            np.testing.assert_array_equal(block, got["ref_rows"][key])
        lo, hi = got["rows"]
        assert hi - lo == 2  # half of the 4 rows


def _jax_streams(jp, ecfg: dict):
    kw = {k: v for k, v in ecfg.items() if k in
          {f.name for f in dataclasses.fields(JEngineConfig)}}
    engine = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                              engine_cfg=JEngineConfig(**kw), params=jp,
                              tokenizer=JNumeric(VOCAB))

    async def drive():
        async with tunnel_stack(engine, j_engine_backend, j_run_serve, j_run_proxy,
                                j_loopback_pair) as base:
            return await conversations(base)

    return asyncio.run(asyncio.wait_for(drive(), 300)), engine


def _ecfg(job):
    args = cli.build_parser().parse_args(
        ["serve", "--backend", "gpu", "--device", "cpu", "--room", "r",
         "--model", "tiny", "--dtype", "float32"] + JOBS[job])
    return dataclasses.asdict(cli._engine_config(args))


@pytest.mark.parametrize("job", ["plain", "defaults-ragged", "int4-fused-spec"])
def test_dp_dcn2_streams_match_the_jax_engine(job, runs, weights, cpu_devices):
    lead, follower = (r[job] for r in runs[1])
    want, jengine = _jax_streams(weights, _ecfg(job))
    assert [list(ids) for ids, _ in lead["streams"]] == [list(ids) for ids, _ in want]
    assert [fin for _, fin in lead["streams"]] == [fin for _, fin in want]
    assert all(len(ids) > 0 for ids, _ in lead["streams"])
    assert lead["fences"] == jengine.config_fences
    assert [r["mesh"] for r in (lead, follower)] == [
        ({"dp": 2, "ep": 1, "tp": 1, "sp": 1}, 0),
        ({"dp": 2, "ep": 1, "tp": 1, "sp": 1}, 1)]
    assert lead["kv_rows"] == follower["kv_rows"] == 2  # (3 + 1) / 2
    assert follower["ops"] > 0


def test_dp_refuses_a_slot_count_it_does_not_divide_like_jax(runs, cpu_devices):
    """num_slots 8 + the scratch slot = 9 rows do not split over dp 2: the
    JAX engine's device_put of its cache refuses, and so do both ranks."""
    mesh = j_make_mesh(dp=2, devices=cpu_devices[:2])
    with pytest.raises(ValueError, match="divisible by 2"):
        JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                         engine_cfg=JEngineConfig(num_slots=8, max_seq=256),
                         mesh=mesh)
    JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                     engine_cfg=JEngineConfig(num_slots=7, max_seq=256), mesh=mesh)
    for r in runs[1]:
        assert "does not divide over dp=2" in r["slots-8"]["error"]


def test_dp_fences_carry_the_jax_reasons(runs, cpu_devices):
    """What the port refuses under a tp mesh (the pool's page I/O) stays
    refused under dp with the same reasons, as the JAX engine on its dp 2
    mesh fences it."""
    j = JInferenceEngine(
        model_cfg=j_get_config("tiny", vocab_size=VOCAB),
        engine_cfg=JEngineConfig(**{k: v for k, v in _ecfg("fences").items()
                                    if k in {f.name for f in
                                             dataclasses.fields(JEngineConfig)}}),
        mesh=j_make_mesh(dp=2, devices=cpu_devices[:2]))
    for r in runs[1]:
        got = r["fences"]["fences"]
        assert got == j.config_fences
        assert {f["knob"] for f in got} >= {"role", "spill_pages"}
