"""The port's embeddings surface against the JAX package, on the CPU:
``transformer.encode_pooled`` (mean-pooled, L2-normalized final hidden
states), the engine's ``embed`` (sub-batches of ``prefill_rows``, each
padded to the bucket of its longest prompt) and the three routes through
the loopback tunnel (/v1/embeddings, Ollama /api/embed and the legacy
/api/embeddings) with tests/test_embeddings.py's contract: shapes, unit
norm, batch and padding invariance, Ollama's default truncation and the
parameter edges.

Both packages run on identical weights (JAX ``init_params``, bridged with
``params_from_numpy``).  Tolerances: fp32 within 1e-5 absolute on unit
vectors (the forwards differ in summation order only); bf16 within
test_golden_logits.py's bf16 bound, 2.5% of max |value|.  A pad row (no
real token) pools to zero in both packages; the comparisons hold every
row.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
from test_torch_engine import _stack

VOCAB = 259
FP32_ATOL = 1e-5
BF16_REL = 0.025  # test_golden_logits.py: 0.02 on |logits| <= 0.8
WEIGHT_SEED = 3
ENGINE = dict(model="tiny", num_slots=4, max_seq=128, dtype="float32")


def _params(name="tiny", dtype="float32"):
    jcfg = j_get_config(name, vocab_size=VOCAB)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(WEIGHT_SEED), jnp.dtype(dtype))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              getattr(torch, dtype))
    return jcfg, get_config(name, vocab_size=VOCAB), jp, tp


def _batch(lengths, width, seed=21):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (len(lengths), width)).astype(np.int32)
    valid = np.arange(width)[None, :] < np.asarray(lengths)[:, None]
    return np.where(valid, tokens, 0), valid


# ---------------------------------------------------------------------------
# encode_pooled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [("tiny", "float32"), ("tiny-gemma", "float32"),
                                        ("tiny-qwen", "float32"),
                                        ("tiny-moe", "float32"), ("tiny", "bfloat16")])
def test_encode_pooled_matches_jax(name, dtype):
    """Every row, a pad row (no real token: zero in both) included."""
    jcfg, cfg, jp, tp = _params(name, dtype)
    tokens, valid = _batch([16, 9, 1, 0], 16)
    want = np.asarray(jt.encode_pooled(jcfg, jp, jnp.asarray(tokens),
                                       jnp.asarray(valid)))
    got = tt.encode_pooled(cfg, tp, torch.from_numpy(tokens).long(),
                           torch.from_numpy(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, cfg.dim)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    else:
        assert np.abs(got.numpy() - want).max() < BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[:3], axis=-1), 1.0,
                               atol=1e-5)
    assert not got[3].any()


def test_encode_pooled_is_padding_and_batch_invariant():
    """A row's vector does not change with its batch's other rows or with
    the padded width (the masked mean ignores padding)."""
    _, cfg, _, tp = _params()
    tokens, valid = _batch([5, 12], 16)
    both = tt.encode_pooled(cfg, tp, torch.from_numpy(tokens).long(),
                            torch.from_numpy(valid))
    alone = tt.encode_pooled(cfg, tp, torch.from_numpy(tokens[:1, :5]).long(),
                             torch.from_numpy(valid[:1, :5]))
    torch.testing.assert_close(both[0], alone[0], atol=FP32_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the engine's embed
# ---------------------------------------------------------------------------

PROMPTS = [list(f"text {i}: ".encode()) * (1 + i % 4) for i in range(7)]


@pytest.mark.parametrize("prefill_rows", [3, 8])
def test_embed_matches_the_jax_engine(prefill_rows):
    """Seven prompts in sub-batches of 3 (three sub-batches, the last
    short) and of 8 (one), against the JAX engine's ``embed`` on the same
    weights."""
    _, _, jp, tp = _params()
    kw = dict(ENGINE, prefill_rows=prefill_rows)
    want = asyncio.run(JInferenceEngine(engine_cfg=JEngineConfig(**kw),
                                        params=jp).embed(PROMPTS))
    engine = InferenceEngine(engine_cfg=EngineConfig(**kw), params=tp, device="cpu")
    calls = []
    encode = engine._encode
    engine._encode = lambda tokens, valid: calls.append(tokens.shape) or encode(
        tokens, valid)
    got = asyncio.run(engine.embed(PROMPTS))
    assert got.shape == (len(PROMPTS), engine.mcfg.dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    # prefill_rows-tall sub-batches, each at its longest prompt's bucket.
    assert len(calls) == -(-len(PROMPTS) // prefill_rows)
    for i, shape in enumerate(calls):
        chunk = PROMPTS[i * prefill_rows:(i + 1) * prefill_rows]
        assert shape == (prefill_rows, engine._bucket(max(map(len, chunk))))


def test_embed_on_a_crashed_engine_raises():
    _, _, _, tp = _params()
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE), params=tp, device="cpu")
    engine._crashed = True
    with pytest.raises(RuntimeError, match="crashed"):
        asyncio.run(engine.embed(PROMPTS[:1]))


# ---------------------------------------------------------------------------
# the three routes through the tunnel (tests/test_embeddings.py's contract)
# ---------------------------------------------------------------------------

async def _post(base, path, payload):
    resp = await http11.http_request(
        "POST", f"{base}{path}", {"content-type": "application/json"},
        json.dumps(payload).encode(), timeout=120.0)
    return resp.status, json.loads(await resp.read_all())


def _run(check):
    _, _, _, tp = _params()
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE), params=tp, device="cpu")

    async def run():
        async with _stack(engine, engine_backend, run_serve, run_proxy,
                          loopback_pair) as base:
            await check(base, engine)

    asyncio.run(run())


def test_openai_embeddings_shape_and_invariance():
    async def check(base, engine):
        status, obj = await _post(base, "/v1/embeddings", {"input": ["abc", "hello world"]})
        assert status == 200 and obj["object"] == "list"
        assert [d["index"] for d in obj["data"]] == [0, 1]
        v0 = np.asarray(obj["data"][0]["embedding"])
        assert v0.shape == (engine.mcfg.dim,)
        assert abs(np.linalg.norm(v0) - 1.0) < 1e-4
        assert obj["usage"]["prompt_tokens"] == len("abc") + len("hello world")
        # Determinism and batch-composition invariance.
        _, solo = await _post(base, "/v1/embeddings", {"input": "abc"})
        np.testing.assert_allclose(v0, solo["data"][0]["embedding"], atol=1e-5)
        # A longer sibling forces a wider bucket: padding is ignored.
        _, wide = await _post(base, "/v1/embeddings", {"input": ["abc", "a" * 60]})
        np.testing.assert_allclose(v0, wide["data"][0]["embedding"], atol=1e-4)

    _run(check)


def test_ollama_embed_shapes():
    async def check(base, engine):
        status, obj = await _post(base, "/api/embed", {"input": ["abc", "def"]})
        assert status == 200 and len(obj["embeddings"]) == 2
        assert len(obj["embeddings"][0]) == engine.mcfg.dim
        status, obj = await _post(base, "/api/embeddings", {"prompt": "abc"})
        assert status == 200 and len(obj["embedding"]) == engine.mcfg.dim
        status, _ = await _post(base, "/v1/embeddings", {"input": []})
        assert status == 400

    _run(check)


def test_embed_param_edges():
    """Ollama truncates an over-length input by default; generation-only
    params are ignored; OpenAI's unsupported knobs and an over-length input
    answer 400."""
    async def check(base, engine):
        status, _ = await _post(base, "/api/embed", {"input": "x" * 500})
        assert status == 200
        status, _ = await _post(base, "/api/embed",
                                {"input": "abc", "options": {"num_predict": 0}})
        assert status == 200
        for extra in ({"encoding_format": "base64"}, {"dimensions": 8}):
            status, _ = await _post(base, "/v1/embeddings", dict(input="abc", **extra))
            assert status == 400
        status, _ = await _post(base, "/v1/embeddings", {"input": "x" * 500})
        assert status == 400

    _run(check)
