"""The port's tensor-parallel serving (``parallel/spmd_serve``, the engine's
SPMD dispatch) against the JAX package, on the CPU.

Two gloo ranks (spawned processes, ``torch_tp_ranks``; one spawn serves
every engine job of the module) build a tp 2 port engine on JAX's weights
(JAX ``init_params`` at fp32, bridged with ``params_from_numpy``; each
rank's engine shards them itself).  Rank 0 serves a two-turn conversation
mix through the port's tunnel stack (``loopback_pair`` + ``run_serve`` +
``run_proxy``, real HTTP, SSE and NDJSON) while rank 1 replays its
dispatches.  The greedy streams must be byte-identical to the JAX engine's
behind its own tunnel stack, on the same traffic:

- plain loop, serve-CLI defaults (mux, prefix pool, conversation cache;
  ``ragged_prefill`` requested and fenced under tp, as in JAX), ``kv_quant``
  int8 and int4 (the int4 job also asks for the fused decode layer, which
  the model layer does not run under tp — JAX's ``kernel_ok`` needs
  tp == 1 — so both engines decode unfused), and ``spec_ngram`` (the
  verify burst on the chunk path under tp, as in JAX): against the JAX
  single-chip engine.  At fp32 a tp 2 forward differs from one whole
  forward only in summation order, and the weight seed is tie-free for
  this traffic.
- ``quant`` int8 and int4, also against the JAX single-chip engine, on
  weights of their own seed.  A quantized embedding gathers into bf16
  activations, and under kernel 7's rules each rank rounds its share of a
  row-parallel product to bf16 before the all-reduce, where one whole
  product rounds once (and JAX's tp 2 mesh rounds its partial products
  before the psum and the scale after it).  At bf16 the logits step in
  ulps of 1/64 and exact ties are common: on the seed-3 tree the int8
  forward has one in turn 1 of conversation 2, where all three rounding
  orders part — JAX's own tp 2 mesh engine parts from its single-chip
  engine there.  Seed 6 is tie-free at bf16 for this traffic: the port's
  tp 2 streams, JAX's single-chip streams and JAX's tp 2 mesh streams are
  identical on it.  No tolerance is widened to hide a difference.

Lockstep: rank 1's sampled ids equal rank 0's at every dispatch of every
job.  Fences: JAX's reasons under tp.  The control plane alone (length
header + pickled payload over a gloo group) is pinned by a wire test.
"""

import asyncio

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
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.models.transformer import init_params
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine

from torch_tp_ranks import conversations, run_ranks, tunnel_stack

VOCAB = 512
WEIGHT_SEED = 3  # tie-free at fp32 for the traffic below
QUANT_SEED = 6  # tie-free at bf16 (the quantized forms) for the same traffic
PLAIN = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32",
             decode_steps=4)
DEFAULTS = dict(PLAIN, mux=True, prefix_cache=True, conv_cache=True,
                prefill_chunk=32)
#: job -> (port engine kwargs, JAX engine kwargs, weight seed); the JAX
#: reference is the single-chip engine on the same fp32 tree (each engine
#: quantizes it under ``quant``).
JOBS = {
    "plain": (PLAIN, PLAIN, WEIGHT_SEED),
    "defaults": (dict(DEFAULTS, ragged_prefill=True), DEFAULTS, WEIGHT_SEED),
    "kv-int8": (dict(DEFAULTS, kv_quant="int8"), dict(DEFAULTS, kv_quant="int8"),
                WEIGHT_SEED),
    "kv-int4": (dict(DEFAULTS, kv_quant="int4", fused_decode_layer=True),
                dict(DEFAULTS, kv_quant="int4"), WEIGHT_SEED),
    "spec": (dict(DEFAULTS, spec_ngram=3, spec_k=4),
             dict(DEFAULTS, spec_ngram=3, spec_k=4), WEIGHT_SEED),
    "quant-int8": (dict(DEFAULTS, quant="int8"), dict(DEFAULTS, quant="int8"),
                   QUANT_SEED),
    "quant-int4": (dict(DEFAULTS, quant="int4", quant_group_size=16),
                   dict(DEFAULTS, quant="int4", quant_group_size=16), QUANT_SEED),
}


@pytest.fixture(scope="module")
def weights():
    """seed -> the JAX fp32 tree."""
    return {seed: init_params(j_get_config("tiny", vocab_size=VOCAB),
                              jax.random.PRNGKey(seed), jnp.float32)
            for seed in {seed for _, _, seed in JOBS.values()}}


@pytest.fixture(scope="module")
def snapshot_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("snapshots") / "pool"


@pytest.fixture(scope="module")
def port_runs(weights, snapshot_dir, tmp_path_factory):
    jobs = {name: dict(engine=dict(kw), weights=seed)
            for name, (kw, _, seed) in JOBS.items()}
    # A snapshot directory on one job: under SPMD nothing is loaded from
    # it or saved into it (test_snapshots_are_skipped_under_spmd).
    jobs["kv-int8"]["engine"]["prefix_cache_dir"] = str(snapshot_dir)
    payload = dict(vocab=VOCAB, jobs=jobs, weights={
        seed: jax.tree.map(np.asarray, jp) for seed, jp in weights.items()})
    return run_ranks("engine_streams", 2, payload, tmp_path_factory.mktemp("spmd"),
                     timeout_s=400.0)


def _jax_streams(jp, kw):
    engine = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                              engine_cfg=JEngineConfig(**kw), params=jp,
                              tokenizer=JNumeric(VOCAB))

    async def drive():
        async with tunnel_stack(engine, j_engine_backend, j_run_serve, j_run_proxy,
                                j_loopback_pair) as base:
            return await conversations(base)

    return asyncio.run(asyncio.wait_for(drive(), 300))


@pytest.mark.parametrize("job", sorted(JOBS))
def test_tp2_streams_match_jax(job, port_runs, weights):
    _, jkw, seed = JOBS[job]
    got = port_runs[0][job]["streams"]
    want = _jax_streams(weights[seed], jkw)
    assert [list(ids) for ids, _ in got] == [list(ids) for ids, _ in want]
    assert [fin for _, fin in got] == [fin for _, fin in want]
    assert all(len(ids) > 0 for ids, _ in got)
    assert port_runs[0][job]["mesh"] == ({"dp": 1, "ep": 1, "tp": 2, "sp": 1}, 0)
    assert port_runs[0][job]["kv_shape"][3] == 1  # tiny's 2 kv heads over tp 2


@pytest.mark.parametrize("job", sorted(JOBS))
def test_followers_sample_what_rank0_samples(job, port_runs):
    lead, follower = port_runs[0][job]["ids"], port_runs[1][job]["ids"]
    assert lead and follower == lead
    kinds = {name for name, _ in lead}
    # Speculation decodes in verify bursts only (every row is greedy).
    assert ("_spec_verify_fn" if job == "spec" else "_decode_fn") in kinds
    # Every op rank 0 sent was replayed (ops include pool copies, bias
    # writes and heartbeats beyond the recorded dispatches).
    assert port_runs[1][job]["ops"] >= len(lead)


def test_ragged_prefill_fenced_under_tp_with_the_jax_reason(port_runs, cpu_devices):
    j = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                         engine_cfg=JEngineConfig(**JOBS["defaults"][0], tp=2))
    assert port_runs[0]["defaults"]["fences"] == j.config_fences
    assert [f["knob"] for f in j.config_fences] == ["ragged_prefill"]


@pytest.fixture(scope="module")
def fence_runs(tmp_path_factory):
    configs = {
        "role": dict(DEFAULTS, role="prefill"),
        "spill": dict(DEFAULTS, spill_pages=8),
    }
    return configs, run_ranks("engine_fences", 2, dict(vocab=VOCAB, configs=configs),
                              tmp_path_factory.mktemp("fences"))


@pytest.mark.parametrize("name", ["role", "spill"])
def test_mesh_fences_carry_the_jax_reasons(name, fence_runs, cpu_devices):
    configs, ranks = fence_runs
    j = JInferenceEngine(model_cfg=j_get_config("tiny", vocab_size=VOCAB),
                         engine_cfg=JEngineConfig(**configs[name], tp=2))
    fences, ecfg = ranks[0][name]
    assert fences == j.config_fences and len(fences) == 1
    assert ecfg == {k: getattr(j.ecfg, k) for k in ecfg}


def test_snapshots_are_skipped_under_spmd(port_runs, snapshot_dir):
    """No prefix snapshot is saved (nor loaded) under multi-process
    serving: the job served with a snapshot directory and stopped, and the
    directory was never written."""
    assert port_runs[0]["kv-int8"]["streams"]
    assert not snapshot_dir.exists()


@pytest.mark.parametrize("knob,item", [("sp", "18b"), ("ep", "18c")])
def test_unported_knobs_still_refuse(knob, item):
    # Items 18b and 18c are ported: an sp 2 or ep 2 engine needs its two
    # ranks, as a tp 2 engine does (test_tp_engine_needs_its_ranks).
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        InferenceEngine(engine_cfg=EngineConfig(**PLAIN, **{knob: 2}), device="cpu")


def test_tp_engine_needs_its_ranks():
    """A tp 2 engine in a process that joined no run: refused, never
    quietly served from one rank."""
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        InferenceEngine(engine_cfg=EngineConfig(**PLAIN, tp=2), device="cpu")


def test_control_plane_wire(tmp_path):
    """rank 0's wrapped call broadcasts its host inputs (numpy arrays,
    scalars, nested tuples, None) and each rank calls the wrapped function
    with its own carry and the same host inputs; the stop op ends it."""
    payload = [
        (np.arange(6, dtype=np.int32).reshape(2, 3), 7, "x"),
        (np.zeros((0,), np.float32), (1.5, None), [np.uint32(3)]),
        (),
    ]
    lead, follower = run_ranks("coordinator_wire", 2, payload, tmp_path)
    assert lead["sent"] == len(payload) + 1
    assert lead["wrapped"] == follower["wrapped"] == ("op", True)
    for got in (lead, follower):
        assert len(got["seen"]) == len(payload)
        for (carry, host), want in zip(got["seen"], payload):
            assert carry.startswith("carry-")
            assert len(host) == len(want)
            for a, b in zip(host, want):
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype
                else:
                    assert a == b
    assert [op for op, _ in follower["got"]] == ["op"] * len(payload) + ["stop"]
    assert {c for c, _ in follower["seen"]} == {"carry-1"}
