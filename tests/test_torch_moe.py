"""The port's mixture-of-experts MLP (models/moe.py) and the tiny-moe model
against the JAX package, on the CPU.

Both packages run on identical weights: JAX ``init_params`` draws them,
``params_from_numpy`` bridges the numpy leaves (the four MoE leaves
included).  Tolerances: fp32 within 1e-5 (absolute and relative) for the
MLP block and its router weights, whose only difference is summation
order; fp32 model logits within test_torch_transformer.py's 1e-4 (more
ops between input and output); bf16 within test_golden_logits.py's bf16
bound, 2.5% of max |value|.  ``torch.topk`` and ``jax.lax.top_k`` may
break an exact tie of router probabilities differently: the weight seeds
here have no tie in any row's top k (``test_router_seeds_are_tie_free``
checks it for the inputs the other tests use).

The expert products read the stored ``[E, Dm, F]`` weights in place: no
clone, copy or contiguous in the block takes an input of an expert
weight's size, forward or backward, where the einsum formulation
(tests/test_torch_moe_card.py's ``einsum_moe``) copies each weight; the
block's output equals that formulation's on one row, an odd row count
and several batches and positions (the card file holds both at
mixtral-8x7b's widths).

Greedy streams of the port's tiny-moe engine through the loopback tunnel
are byte-identical to the JAX engine's on every engine path that reaches
the MLP: the plain loop, the serve defaults with chunk prefill and with
ragged prefill, the int4 KV cache with the fused decode layer and ragged
prefill, and prompt-lookup speculation unfused and fused (the
JAX package pins mux, ragged, fused and speculation against its plain
loop for greedy streams, and its int4-cache serve defaults against their
unfused, unragged run; weight seed 3).  Quantized MoE is refused, as in
the JAX package.
"""

import dataclasses

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
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu.utils.metrics import global_metrics as j_metrics
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
from p2p_llm_tunnel_tpu_torch.models import moe as tmoe
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics
from test_torch_moe_card import einsum_moe
from test_torch_mux import N_CONV, _drive

VOCAB = 259
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 0.025  # test_golden_logits.py: 0.02 on |logits| <= 0.8
WEIGHT_SEED = 3  # tie-free router top-k for the inputs and traffic below
MOE_LEAVES = ("router", "moe_gate", "moe_up", "moe_down")


def _params(dtype="float32", seed=WEIGHT_SEED, **over):
    jcfg = j_get_config("tiny-moe", vocab_size=VOCAB, **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              getattr(torch, dtype))
    return jcfg, get_config("tiny-moe", vocab_size=VOCAB, **over), jp, tp


def _hidden(shape, dtype, seed=7):
    h = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jh = jnp.asarray(h, jnp.dtype(dtype))
    return jh, torch.from_numpy(np.asarray(jh.astype(jnp.float32))).to(getattr(torch, dtype))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if tol is None:
        diff, scale = np.abs(got - want).max(), np.abs(want).max()
        assert diff < BF16_REL * scale, (diff, scale)
    else:
        np.testing.assert_allclose(got, want, **tol)


def _layer(params, idx=0):
    return {k: v[idx] for k, v in params["blocks"].items()}


def _act(x):
    return torch.nn.functional.silu(x)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def test_router_seeds_are_tie_free():
    """The router probabilities of the test inputs have a gap between the
    k-th and (k+1)-th expert in every row, so top-k picks the same experts
    in both packages."""
    _, cfg, _, tp = _params()
    for seed in (7, 8):
        _, th = _hidden((2, 5, cfg.dim), "float32", seed)
        logits = th @ tp["blocks"]["router"][0]
        top = torch.softmax(logits, -1).sort(-1, descending=True).values
        k = cfg.n_experts_per_tok
        assert (top[..., k - 1] - top[..., k]).min() > 1e-4


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(dtype, seed):
    jcfg, cfg, jp, tp = _params(dtype)
    jh, th = _hidden((2, 5, cfg.dim), dtype, seed)
    want = jmoe.moe_mlp(jcfg, _layer(jp), jh, jax.nn.silu)
    got = tmoe.moe_mlp(cfg, _layer(tp), th, _act)
    assert got.dtype == th.dtype and got.shape == th.shape
    _close(got, want, FP32_TOL if dtype == "float32" else None)


def test_router_weights_match_jax():
    """The dense [B, T, E] weight map: k nonzero weights summing to 1 per
    row, on the experts the reference routes to, within 1e-5."""
    jcfg, cfg, jp, tp = _params()
    jh, th = _hidden((2, 5, cfg.dim), "float32")
    got = tmoe.route(cfg, tp["blocks"]["router"][0], th)
    logits = jh @ jp["blocks"]["router"][0]
    top_p, top_i = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.n_experts_per_tok)
    top_p = top_p / top_p.sum(-1, keepdims=True)
    want = (jax.nn.one_hot(top_i, jcfg.n_experts) * top_p[..., None]).sum(-2)
    _close(got, want, FP32_TOL)
    assert ((got > 0).sum(-1) == cfg.n_experts_per_tok).all()
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 5))


def test_zero_rows_route_and_compute_finite():
    """Pad and parked rows are routed like any row: a zero row gives a
    uniform softmax, finite weights summing to 1 and a finite output."""
    _, cfg, _, tp = _params()
    h = torch.zeros(1, 3, cfg.dim)
    w = tmoe.route(cfg, tp["blocks"]["router"][0], h)
    assert torch.isfinite(w).all()
    torch.testing.assert_close(w.sum(-1), torch.ones(1, 3))
    out = tmoe.moe_mlp(cfg, _layer(tp), h, _act)
    assert torch.isfinite(out).all()


def test_single_expert_equals_the_dense_mlp():
    """E 1, k 1: the router weighs the only expert by exactly 1, so the
    model's logits equal the dense model's on the same weights (the JAX
    package's tests/test_moe.py oracle)."""
    dense_cfg = get_config("tiny", vocab_size=VOCAB)
    moe_cfg = get_config("tiny-moe", vocab_size=VOCAB, n_experts=1,
                         n_experts_per_tok=1)
    dense = tt.init_params(dense_cfg, 0, torch.float32, "cpu")
    moe = tt.init_params(moe_cfg, 0, torch.float32, "cpu")
    for name in ("embed", "final_norm", "lm_head"):
        moe[name] = dense[name]
    for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo"):
        moe["blocks"][name] = dense["blocks"][name]
    for src, dst in (("w_gate", "moe_gate"), ("w_up", "moe_up"),
                     ("w_down", "moe_down")):
        moe["blocks"][dst] = dense["blocks"][src][:, None]
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, (2, 12)))
    valid = torch.ones_like(tokens, dtype=torch.bool)
    want, _, _ = tt.prefill(dense_cfg, dense, tokens, valid)
    got, _, _ = tt.prefill(moe_cfg, moe, tokens, valid)
    torch.testing.assert_close(got, want, **FP32_TOL)


# ---------------------------------------------------------------------------
# the expert products on the stored [E, Dm, F] layout
# ---------------------------------------------------------------------------

COPY_OPS = ("aten::clone", "aten::copy_", "aten::contiguous")


def _largest_copy(prof):
    """The most elements any copying op of the profile took as an input."""
    return max((np.prod(s) for ev in prof.events() if ev.name in COPY_OPS
                for s in ev.input_shapes if s), default=0)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_copies_no_expert_weight(dtype, grad):
    """No clone, copy or contiguous in the block takes an input of an
    expert weight's size (``n_experts * dim * ffn_dim`` elements): the
    products read the stored layout in place, forward and, under
    autograd, backward.  The einsum formulation is the control: it
    copies the whole weight."""
    _, cfg, _, tp = _params(dtype)
    blk = _layer(tp)
    if grad:
        blk = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
    _, h = _hidden((2, 5, cfg.dim), dtype)
    weight = cfg.n_experts * cfg.dim * cfg.ffn_dim
    with torch.profiler.profile(record_shapes=True, profile_memory=True) as prof:
        out = tmoe.moe_mlp(cfg, blk, h, _act)
        if grad:
            out.float().sum().backward()
    assert _largest_copy(prof) < weight
    with torch.no_grad(), torch.profiler.profile(record_shapes=True) as prof:
        einsum_moe(cfg, _layer(tp), h, _act)
    assert _largest_copy(prof) >= weight


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 5), (5, 1)],
                         ids=["one-row", "odd-rows", "batch-and-time", "decode-rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_the_einsum_formulation(dtype, shape):
    """The expert-major products give the einsum formulation's output:
    fp32 within 1e-5, bf16 within the file's bf16 bound."""
    _, cfg, _, tp = _params(dtype)
    _, h = _hidden(shape + (cfg.dim,), dtype, seed=9)
    got = tmoe.moe_mlp(cfg, _layer(tp), h, _act)
    want = einsum_moe(cfg, _layer(tp), h, _act)
    assert got.dtype == h.dtype and got.shape == h.shape
    _close(got, want.float().numpy(), FP32_TOL if dtype == "float32" else None)


# ---------------------------------------------------------------------------
# the tiny-moe model
# ---------------------------------------------------------------------------

def test_init_params_draws_the_moe_tree():
    """The port's random init has the reference's MoE leaves (router and
    experts in place of the dense MLP), shapes and dtypes; on the meta
    device it allocates nothing."""
    jcfg, cfg, _, _ = _params()
    want = jax.eval_shape(lambda k: jt.init_params(jcfg, k, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    for device in ("cpu", "meta"):
        got = tt.init_params(cfg, 1, torch.bfloat16, device)
        assert sorted(got["blocks"]) == sorted(want["blocks"])
        for name in MOE_LEAVES:
            assert tuple(got["blocks"][name].shape) == want["blocks"][name].shape
            assert got["blocks"][name].device.type == device
        assert "w_gate" not in got["blocks"]
    experts = tt.init_params(cfg, 1, torch.float32, "cpu")["blocks"]["moe_gate"]
    # trunc-normal on [-2, 2] has std 0.8796, scaled by fan_in ** -0.5.
    assert abs(experts.std().item() * cfg.dim ** 0.5 - 0.8796) < 0.05


def test_params_from_numpy_carries_the_moe_leaves():
    _, _, jp, tp = _params()
    for name in MOE_LEAVES:
        np.testing.assert_array_equal(tp["blocks"][name].numpy(),
                                      np.asarray(jp["blocks"][name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_moe_prefill_logits_match_jax(dtype):
    jcfg, cfg, jp, tp = _params(dtype)
    tokens = np.random.default_rng(11).integers(0, VOCAB, (2, 16)).astype(np.int32)
    valid = np.ones(tokens.shape, bool)
    valid[1, 11:] = False
    want, jk, _ = jt.prefill(jcfg, jp, jnp.asarray(tokens), jnp.asarray(valid))
    got, tk, _ = tt.prefill(cfg, tp, torch.from_numpy(tokens).long(),
                            torch.from_numpy(valid))
    tol = LOGIT_TOL if dtype == "float32" else None
    _close(got[0], want[0], tol)
    _close(got[1, :11], want[1, :11], tol)
    _close(tk, jk, FP32_TOL if dtype == "float32" else None)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_moe_decode_step_matches_jax(fused):
    """A prefill then one decode step per slot, unfused (kernel 2's plain
    version) and through the fused decode layer (kernel 4's), against the
    JAX decode step: fp32 logits within 1e-4."""
    jcfg, cfg, jp, tp = _params()
    cfg = dataclasses.replace(cfg, fused_decode_layer=fused)
    tokens = np.random.default_rng(12).integers(0, VOCAB, (2, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    slots = np.array([0, 1], np.int32)
    jc = jt.init_kv_cache(jcfg, 2, 32, jnp.float32)
    tc = tt.init_kv_cache(cfg, 2, 32, torch.float32, device="cpu")
    _, jc = jt.prefill_into_cache(jcfg, jp, jnp.asarray(tokens), jnp.asarray(lengths),
                                  jc, jnp.asarray(slots))
    _, tc = tt.prefill_into_cache(cfg, tp, torch.from_numpy(tokens).long(),
                                  torch.from_numpy(lengths), tc,
                                  torch.from_numpy(slots))
    nxt = np.array([17, 42], np.int32)
    want, _ = jt.decode_step(jcfg, jp, jc, jnp.asarray(nxt), jnp.asarray(lengths))
    got, _ = tt.decode_step(cfg, tp, tc, torch.from_numpy(nxt).long(),
                            torch.from_numpy(lengths))
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("quant", ["int8", "w8a8", "int4"])
def test_quantized_moe_is_refused_as_in_jax(quant):
    """The JAX package refuses to quantize MoE expert weights; so does the
    port, with its own message, on random init and on injected weights."""
    _, _, _, tp = _params("bfloat16")
    kw = dict(model="tiny-moe", num_slots=2, max_seq=64, quant=quant)
    with pytest.raises(NotImplementedError, match="MoE"):
        InferenceEngine(engine_cfg=EngineConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        InferenceEngine(engine_cfg=EngineConfig(**kw), params=tp, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        JInferenceEngine(engine_cfg=JEngineConfig(**kw))


# ---------------------------------------------------------------------------
# greedy streams through the tunnel
# ---------------------------------------------------------------------------

ENGINE = dict(model="tiny-moe", num_slots=4, max_seq=256, dtype="float32",
              decode_steps=4)
SERVE_DEFAULTS = dict(mux=True, prefix_cache=True, conv_cache=True, prefill_chunk=32)
#: path -> (port engine knobs, JAX engine knobs): the JAX plain loop is
#: the raw cache's reference; the int4 cache's is the JAX serve defaults at
#: int4 (its chunked prefill attends quantized history, as the port's).
STREAM_PATHS = {
    "plain": (dict(), dict()),
    "serve-defaults": (dict(SERVE_DEFAULTS), dict()),  # chunk prefill segments
    "serve-defaults-ragged": (dict(SERVE_DEFAULTS, ragged_prefill=True), dict()),
    "int4-fused-ragged": (dict(SERVE_DEFAULTS, kv_quant="int4",
                               fused_decode_layer=True, ragged_prefill=True),
                          dict(SERVE_DEFAULTS, kv_quant="int4")),
    "spec": (dict(spec_ngram=2, spec_k=3), dict()),  # chunk-path verify
    "fused-spec": (dict(fused_decode_layer=True, spec_ngram=2, spec_k=3), dict()),
}
_JAX = {}


def _jax_drive(jp, jax_kw):
    key = tuple(sorted(jax_kw.items()))
    if key not in _JAX:
        _JAX[key] = _drive(
            JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE, **jax_kw), params=jp,
                             tokenizer=JNumeric()),
            j_engine_backend, j_run_serve, j_run_proxy, j_loopback_pair, j_metrics)
    return _JAX[key]


@pytest.mark.parametrize("path", sorted(STREAM_PATHS))
def test_tiny_moe_streams_byte_identical_to_jax(path):
    _, _, jp, tp = _params()
    port_kw, jax_kw = STREAM_PATHS[path]
    want, _ = _jax_drive(jp, jax_kw)
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, **port_kw), params=tp,
                             tokenizer=NumericTokenizer(), device="cpu")
    got, _ = _drive(engine, engine_backend, run_serve, run_proxy, loopback_pair,
                    global_metrics)
    assert got == want
    assert len(got) == 2 * N_CONV and {finish for _, finish in got} == {"length"}
    assert engine.config_fences == [] and engine.mcfg.n_experts == 4
    assert engine.mcfg.fused_decode_layer == port_kw.get("fused_decode_layer", False)
    assert engine.ecfg.ragged_prefill == port_kw.get("ragged_prefill", False)
    assert tt.kv_cache_quant_mode(engine.kv_cache) == port_kw.get("kv_quant")
