"""The port's expert parallelism (``--ep``: a MoE model's experts split over
the ep ranks, ``models/moe.moe_mlp`` summing their f32 partials) against
the JAX package, on the CPU.

- Model level: spawned gloo ranks run layer 0's ``moe_mlp`` and tiny-moe's
  whole-sequence ``prefill`` on their shard of JAX's fp32 weights, at ep 2
  (two ranks), ep 4 and tp 2 x ep 2 (four ranks); each rank's output is
  within 2e-5 (rtol and atol, tests/test_moe.py's EP bound) of JAX's
  ``moe_mlp`` and of JAX's prefill under ``make_mesh(ep=4)`` /
  ``make_mesh(tp=2, ep=2)`` on the 8 virtual CPU devices, and each rank
  holds ``E/ep`` experts.
- Shards: a rank's slice of a tree (``params_from_numpy_sharded``) holds
  experts ``[e*E/ep, (e+1)*E/ep)`` byte for byte, the router and attention
  whole; a tree drawn as one rank's shard (``init_params(mesh=...)``) is
  bitwise ``shard_params`` of the whole tree, at ep, tp and tp x ep.
- Engines: tiny-moe at ep 2 (rank 0 serving the conversations through the
  port's tunnel, rank 1 replaying) on the plain loop and on the serve
  defaults + ragged prefill streams byte-identical greedy ids to the JAX
  engine with ``ep=2`` on the same fp32 weights (weight seed 3), with its
  config fences.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.endpoints.proxy import run_proxy as j_run_proxy
from p2p_llm_tunnel_tpu.endpoints.serve import run_serve as j_run_serve
from p2p_llm_tunnel_tpu.engine.api import engine_backend as j_engine_backend
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.engine.tokenizer import NumericTokenizer as JNumeric
from p2p_llm_tunnel_tpu.models import moe as jmoe
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu.parallel import shard_params as j_shard_params
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.parallel import shard_params
from p2p_llm_tunnel_tpu_torch.parallel.mesh import make_mesh
from p2p_llm_tunnel_tpu_torch.parallel.sharding import params_from_numpy_sharded

from torch_tp_ranks import conversations, run_ranks, tunnel_stack

TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB = 512
WEIGHT_SEED = 3  # tie-free router top-k and greedy ids for the traffic below
#: model case -> (tp, ep)
MODEL_CASES = {"ep2": (1, 2), "ep4": (1, 4), "tp2ep2": (2, 2)}
PLAIN = dict(model="tiny-moe", num_slots=4, max_seq=256, dtype="float32",
             decode_steps=4, tp=1, ep=2)
#: engine job -> its EngineConfig kwargs (both packages).
JOBS = {
    "plain": PLAIN,
    "defaults-ragged": dict(PLAIN, mux=True, prefix_cache=True, conv_cache=True,
                            prefill_chunk=32, ragged_prefill=True),
}


def _weights(seed):
    jcfg = j_get_config("tiny-moe", vocab_size=VOCAB)
    return jcfg, jt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)


def _model_case(name):
    tp, ep = MODEL_CASES[name]
    _, jp = _weights(2)
    rng = np.random.default_rng(5)
    return dict(tp=tp, ep=ep, preset="tiny-moe", overrides=dict(vocab_size=VOCAB),
                params=jax.tree.map(np.asarray, jp),
                h=rng.standard_normal((2, 5, 64)).astype(np.float32),
                tokens=rng.integers(0, VOCAB, size=(2, 8)).astype(np.int32),
                lengths=np.array([8, 5], np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks (ep 2: model case, engine jobs) and one of
    four (ep 4 and tp 2 x ep 2 model cases)."""
    _, jp = _weights(WEIGHT_SEED)
    two = run_ranks("several", 2, [
        ("ep_model", {"ep2": _model_case("ep2")}),
        ("engine_streams", dict(
            vocab=VOCAB, weights={WEIGHT_SEED: jax.tree.map(np.asarray, jp)},
            jobs={name: dict(engine=kw, weights=WEIGHT_SEED, preset="tiny-moe")
                  for name, kw in JOBS.items()})),
    ], tmp_path_factory.mktemp("ep2"), timeout_s=300.0)
    four = run_ranks("ep_model", 4, {n: _model_case(n) for n in ("ep4", "tp2ep2")},
                     tmp_path_factory.mktemp("ep4"), timeout_s=300.0)
    return {2: [r[0] for r in two], 4: four, "engines": [r[1] for r in two]}


@pytest.fixture(scope="module")
def jax_model(cpu_devices):
    """JAX's layer-0 MoE block and prefill logits under each case's mesh."""
    jcfg, jp = _weights(2)
    case = _model_case("ep2")
    blk = {k: v[0] for k, v in jp["blocks"].items()}
    mlp = np.asarray(jmoe.moe_mlp(jcfg, blk, jnp.asarray(case["h"]), jax.nn.silu))
    tokens = jnp.asarray(case["tokens"])
    valid = jnp.arange(tokens.shape[1])[None, :] < jnp.asarray(case["lengths"])[:, None]
    logits = {}
    for name, (tp, ep) in MODEL_CASES.items():
        mesh = j_make_mesh(tp=tp, ep=ep, devices=cpu_devices[:tp * ep])
        sharded = j_shard_params(jp, jcfg, mesh)
        out, _, _ = jax.jit(lambda p: jt.prefill(jcfg, p, tokens, valid,
                                                 mesh=mesh))(sharded)
        logits[name] = np.asarray(out)
    return mlp, logits


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_moe_mlp_and_prefill_match_jax_ep_mesh(name, runs, jax_model):
    tp, ep = MODEL_CASES[name]
    mlp, logits = jax_model
    for r in runs[tp * ep]:
        got = r[name]
        np.testing.assert_allclose(got["mlp"], mlp, **TOL)
        np.testing.assert_allclose(got["logits"], logits[name], **TOL)
        assert got["experts"][1] == 4 // ep  # [L, E/ep, Dm, F]


@pytest.mark.parametrize("tp,ep,rank", [(1, 2, 1), (1, 4, 3), (2, 2, 2)])
def test_rank_slice_holds_its_experts(tp, ep, rank):
    """Rank r of a tp x ep mesh holds experts [e*E/ep, (e+1)*E/ep) of every
    expert leaf byte for byte, the router whole, attention by its tp
    coordinate."""
    jcfg, jp = _weights(2)
    cfg = get_config("tiny-moe", vocab_size=VOCAB)
    mesh = make_mesh(tp=tp, ep=ep, rank=rank)
    got = params_from_numpy_sharded(jax.tree.map(np.asarray, jp), cfg, mesh, "cpu",
                                    torch.float32)
    e, n = mesh.ep_rank, 4 // ep
    for leaf in ("moe_gate", "moe_up", "moe_down"):
        want = np.asarray(jp["blocks"][leaf])[:, e * n:(e + 1) * n]
        np.testing.assert_array_equal(got["blocks"][leaf].numpy(), want)
    np.testing.assert_array_equal(got["blocks"]["router"].numpy(),
                                  np.asarray(jp["blocks"]["router"]))
    w = jcfg.n_heads * jcfg.head_dim // tp
    np.testing.assert_array_equal(
        got["blocks"]["wq"].numpy(),
        np.asarray(jp["blocks"]["wq"])[..., mesh.tp_rank * w:(mesh.tp_rank + 1) * w])


@pytest.mark.parametrize("preset,tp,ep,rank", [
    ("tiny-moe", 1, 2, 1), ("tiny-moe", 1, 4, 2), ("tiny-moe", 2, 2, 3),
    ("tiny", 2, 1, 1), ("tiny", 1, 2, 1),
])
def test_sharded_init_is_the_shard_of_the_whole_tree(preset, tp, ep, rank):
    cfg = get_config(preset, vocab_size=VOCAB)
    mesh = make_mesh(tp=tp, ep=ep, rank=rank)
    whole = shard_params(tt.init_params(cfg, 5, torch.float32, "cpu"), cfg, mesh)
    drawn = tt.init_params(cfg, 5, torch.float32, "cpu", mesh=mesh)

    def flat(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{path}.{k}")
        else:
            yield path, tree

    want = dict(flat(whole))
    got = dict(flat(drawn))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert torch.equal(leaf, want[path]), path


def _jax_streams(kw):
    jcfg, jp = _weights(WEIGHT_SEED)
    engine = JInferenceEngine(model_cfg=jcfg, engine_cfg=JEngineConfig(**kw),
                              params=jp, tokenizer=JNumeric(VOCAB))

    async def drive():
        async with tunnel_stack(engine, j_engine_backend, j_run_serve, j_run_proxy,
                                j_loopback_pair) as base:
            return await conversations(base)

    return asyncio.run(asyncio.wait_for(drive(), 300)), engine


@pytest.mark.parametrize("job", sorted(JOBS))
def test_ep2_streams_match_the_jax_engine_at_ep2(job, runs, cpu_devices):
    got = runs["engines"][0][job]
    want, jengine = _jax_streams(JOBS[job])
    assert "ep" in str(jengine.params["blocks"]["moe_gate"].sharding.spec)
    assert [list(ids) for ids, _ in got["streams"]] == [list(ids) for ids, _ in want]
    assert [fin for _, fin in got["streams"]] == [fin for _, fin in want]
    assert all(len(ids) > 0 for ids, _ in got["streams"])
    assert got["fences"] == jengine.config_fences
    assert got["mesh"] == ({"dp": 1, "ep": 2, "tp": 1, "sp": 1}, 0)
    follower = runs["engines"][1][job]
    assert follower["ids"] == got["ids"] and follower["ops"] >= len(got["ids"])
