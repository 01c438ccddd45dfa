"""The PyTorch port's transformer against the JAX package's, on the CPU.

Both packages run on identical weights: JAX ``init_params`` draws them,
``params_from_numpy`` bridges the numpy leaves into the port.  At fp32 the
two forwards differ only in summation order (tolerance atol/rtol 1e-4 on
logits of |x| <~ 5, 1e-5 on KV planes, which pass through fewer ops).  At
bf16 they round at different places; the bound is tests/test_golden_logits
.py's bf16 tolerance — max |diff| < 0.02 on golden logits of |x| <= 0.8,
i.e. 2.5% of the logits' range — applied as 2.5% of max |logit| on random
weights (logits and KV planes), and verbatim on the golden fixture.  The
float64 golden anchor is held at that file's fp32 tolerance (atol 1e-5,
rtol 1e-4) too.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"
))

from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.checkpoint import convert_hf
from p2p_llm_tunnel_tpu.models.config import ModelConfig as JModelConfig
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig, get_config

VOCAB = 300
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "synth_llama_logits.npz")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": None}
KV_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": None}
BF16_REL = 0.025  # test_golden_logits.py: 0.02 on |logits| <= 0.8


def _params(name, dtype, seed=0):
    jdt = jnp.dtype(dtype)
    jcfg = j_get_config(name, vocab_size=VOCAB)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              getattr(torch, dtype))
    return jcfg, get_config(name, vocab_size=VOCAB), jp, tp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32))


def _close(got, want, dtype, tol):
    got, want = _np(got), _np(want)
    if tol is None:
        diff, scale = np.abs(got - want).max(), np.abs(want).max()
        assert diff < BF16_REL * scale, (diff, scale)
    else:
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_params_from_numpy_is_exact(name):
    _, _, jp, tp = _params(name, "bfloat16")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jleaves:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_prefill_into_cache_then_decode_match_jax(name, dtype):
    jcfg, cfg, jp, tp = _params(name, dtype, seed=1)
    rng = np.random.default_rng(7)
    b, t, slots_n, s = 3, 16, 4, 32
    tokens = rng.integers(0, VOCAB, size=(b, t)).astype(np.int32)
    lengths = np.array([16, 9, 4], np.int32)
    slots = np.array([2, 0, 1], np.int32)

    jcache = jt.init_kv_cache(jcfg, slots_n, s, jnp.dtype(dtype))
    jlast, jcache = jt.prefill_into_cache(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(lengths), jcache,
        jnp.asarray(slots))
    tcache = tt.init_kv_cache(cfg, slots_n, s, getattr(torch, dtype), device="cpu")
    tlast, tcache = tt.prefill_into_cache(
        cfg, tp, torch.from_numpy(tokens), torch.from_numpy(lengths), tcache,
        torch.from_numpy(slots))
    _close(tlast, jlast, dtype, TOL[dtype])
    for r in range(b):
        for plane in ("k", "v"):
            _close(tcache[plane][:, slots[r], : lengths[r]],
                   jcache[plane][:, slots[r], : lengths[r]], dtype, KV_TOL[dtype])

    # Decode every slot: slot i sits at its prompt length; slot 3 is parked
    # past the cache (its output is junk, its write is dropped).
    pos = np.array([9, 4, 16, s], np.int32)
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    toks = np.array([nxt[1], nxt[2], nxt[0], 0], np.int32)
    for _ in range(3):
        jlog, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(toks),
                                      jnp.asarray(pos), kv_view=s)
        tlog, tcache = tt.decode_step(cfg, tp, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(pos), kv_view=s)
        _close(tlog[:3], jlog[:3], dtype, TOL[dtype])
        for plane in ("k", "v"):
            _close(tcache[plane][:, :3], jcache[plane][:, :3], dtype, KV_TOL[dtype])
        toks = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)  # teacher-forced
        pos = pos + np.array([1, 1, 1, 0], np.int32)


def test_prefill_matches_jax_full_logits():
    jcfg, cfg, jp, tp = _params("tiny", "float32", seed=2)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, VOCAB, size=(2, 12)).astype(np.int32)
    valid = np.arange(12)[None, :] < np.array([[12], [7]])
    jlog, jk, jv = jt.prefill(jcfg, jp, jnp.asarray(tokens), jnp.asarray(valid))
    tlog, tk, tv = tt.prefill(cfg, tp, torch.from_numpy(tokens),
                              torch.from_numpy(valid))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL["float32"])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **KV_TOL["float32"])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **KV_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_golden_logits(dtype):
    """The float64 numpy anchor (scripts/make_golden_logits.py) through
    the port, on weights converted by the JAX package's convert_hf, at
    test_golden_logits.py's tolerances for the dtype."""
    from make_synth_hf_ckpt import fake_llama_state

    fx = np.load(GOLDEN)
    vocab, dim, layers, heads, kv_heads, head_dim, ffn, seed = (int(x) for x in fx["meta"])
    fields = dict(name="synth-golden", vocab_size=vocab, dim=dim,
                  n_layers=layers, n_heads=heads, n_kv_heads=kv_heads,
                  head_dim=head_dim, ffn_dim=ffn, rope_theta=10000.0,
                  norm_eps=1e-5)
    shape = types.SimpleNamespace(**{k: v for k, v in fields.items()
                                     if k not in ("name", "rope_theta", "norm_eps")})
    state = fake_llama_state(shape, seed)
    jparams = convert_hf("llama", state, JModelConfig(**fields), jnp.dtype(dtype))
    params = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                  getattr(torch, dtype))
    tokens = torch.from_numpy(np.asarray(fx["tokens"]))[None, :]
    logits, _, _ = tt.prefill(ModelConfig(**fields), params, tokens,
                              torch.ones_like(tokens, dtype=torch.bool))
    got, want = logits[0].numpy(), fx["logits"]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        assert (got.argmax(-1) == want.argmax(-1)).all()
    else:
        assert np.abs(got - want).max() < 0.02
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_parked_rows_write_nothing():
    """XLA's scatter drops out-of-bounds writes and the engine parks idle
    rows at positions >= S; on the port such rows must leave the cache
    untouched (and not raise, which torch indexing past S would)."""
    cfg = get_config("tiny", vocab_size=VOCAB)
    params = tt.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    s = 16
    cache = tt.init_kv_cache(cfg, 3, s, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for plane in ("k", "v"):
        cache[plane].normal_(generator=gen)
    before = {p: cache[p].clone() for p in ("k", "v")}
    pos = torch.tensor([s, s + 5, 3], dtype=torch.int32)
    tt.decode_step(cfg, params, cache, torch.tensor([1, 2, 3]), pos)
    for plane in ("k", "v"):
        assert torch.equal(cache[plane][:, :2], before[plane][:, :2])
        changed = (cache[plane][:, 2] != before[plane][:, 2]).any(dim=(0, 2, 3))
        assert changed.nonzero().flatten().tolist() == [3]


def test_init_params_matches_reference_layout():
    """Same tree, shapes and fan-in scaling as the JAX init (the draws
    differ: torch.Generator, not jax.random)."""
    for name in ("tiny", "tiny-gemma"):
        jcfg = j_get_config(name, vocab_size=VOCAB)
        ref = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
        got = tt.init_params(get_config(name, vocab_size=VOCAB), seed=0,
                             device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), ref) == jax.tree.map(
            lambda a: tuple(a.shape), got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    wq = got["blocks"]["wq"].float()
    # trunc-normal on [-2, 2] has std 0.8796; scaled by fan_in ** -0.5.
    assert abs(wq.std().item() * 64 ** 0.5 - 0.8796) < 0.05
    assert wq.abs().max().item() <= 2.0 * 64 ** -0.5 + 1e-3


def test_unported_knobs_and_missing_card_raise():
    cfg = get_config("tiny", vocab_size=VOCAB)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_kv_cache(cfg, 2, 16, quant="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_params(get_config("tiny-moe", vocab_size=VOCAB), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.init_params(cfg)
