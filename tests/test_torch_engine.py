"""The PyTorch engine against the JAX engine, end to end on the CPU.

Both engines run the tiny model at fp32 on the same weights (JAX
``init_params``, bridged with ``params_from_numpy``), each behind its own
package's tunnel stack — ``engine_backend`` over ``loopback_pair`` +
``run_serve`` + ``run_proxy`` — and both are driven with real HTTP
against the proxy port: more concurrent requests than slots, SSE
``/v1/chat/completions`` and NDJSON ``/api/generate``.  Greedy streams
must be byte-identical, under the byte-level tokenizer and under the
numeric one, which renders every token id as visible text (so equal bytes
mean equal ids).  The weight seed is tie-free: at fp32 the two
forwards differ only in summation order, which can flip an argmax only
where two logits (near-)tie.
"""

import asyncio
import contextlib
import json

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
from p2p_llm_tunnel_tpu.models.config import get_config
from p2p_llm_tunnel_tpu.models.transformer import init_params
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import (
    EngineConfig,
    InferenceEngine,
    NotPorted,
)
from p2p_llm_tunnel_tpu.engine import tokenizer as j_tokenizer
from p2p_llm_tunnel_tpu_torch.engine import tokenizer as t_tokenizer
from p2p_llm_tunnel_tpu_torch.models.transformer import params_from_numpy
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

ENGINE = dict(model="tiny", num_slots=4, max_seq=128, dtype="float32")
WEIGHT_SEED = 3  # tie-free for the requests below
N_REQUESTS = 7  # > num_slots: admissions wait and land mid-decode


@pytest.fixture(scope="module")
def weights():
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                 torch.float32)


@contextlib.asynccontextmanager
async def _stack(engine, backend, serve, proxy, pair):
    await engine.start()
    serve_ch, proxy_ch = pair()
    ready = asyncio.get_running_loop().create_future()
    serve_task = asyncio.create_task(serve(serve_ch, backend=backend(engine, "tiny")))
    proxy_task = asyncio.create_task(proxy(proxy_ch, "127.0.0.1", 0, ready=ready))
    port = await asyncio.wait_for(ready, 10.0)
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        serve_ch.close()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        await engine.stop()


async def _request(base: str, i: int):
    """One streamed request; returns its content bytes in stream order."""
    if i % 2 == 0:
        path, sep = "/v1/chat/completions", b"\n\n"
        body = {"messages": [{"role": "user", "content": f"question {i}?"}],
                "max_tokens": 6 + i, "stream": True}
    else:
        path, sep = "/api/generate", b"\n"
        body = {"prompt": f"prompt number {i} " * (1 + i % 3),
                "max_new_tokens": 6 + i}
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=120.0,
    )
    assert resp.status == 200
    raw = await resp.read_all()
    out = []
    for line in raw.split(sep):
        line = line.strip()
        if not line or line == b"data: [DONE]":
            continue
        if line.startswith(b"data: "):
            obj = json.loads(line[len(b"data: "):])
            out.append(obj["choices"][0]["delta"].get("content") or "")
            last = obj["choices"][0].get("finish_reason")
        else:
            obj = json.loads(line)
            out.append(obj.get("response", ""))
            last = obj.get("done_reason")
    return "".join(out).encode("utf-8", "surrogatepass"), last


async def _drive(engine, backend, serve, proxy, pair):
    async with _stack(engine, backend, serve, proxy, pair) as base:
        return await asyncio.gather(*[_request(base, i) for i in range(N_REQUESTS)])


@pytest.mark.parametrize("tokenizer", ["ByteTokenizer", "NumericTokenizer"])
def test_greedy_streams_byte_identical_to_jax(weights, tokenizer):
    jp, tp = weights
    want = asyncio.run(_drive(
        JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE), params=jp,
                         tokenizer=getattr(j_tokenizer, tokenizer)()),
        j_engine_backend, j_run_serve, j_run_proxy, j_loopback_pair))
    got = asyncio.run(_drive(
        InferenceEngine(engine_cfg=EngineConfig(**ENGINE), params=tp,
                        tokenizer=getattr(t_tokenizer, tokenizer)(),
                        device="cpu"),
        engine_backend, run_serve, run_proxy, loopback_pair))
    assert got == want
    assert all(text for text, _ in got)
    assert {finish for _, finish in got} <= {"stop", "length"}


def test_generate_matches_jax_with_logprobs(weights):
    """The engine API directly: token ids and chosen-token logprobs of
    overlapping requests, some with frequency/presence penalties and some
    with a logit bias — both shift greedy choices through the on-device
    counts and bias planes (fp32 logprobs: atol 1e-4)."""
    jp, tp = weights
    extra = [{}, {"freq_pen": 0.8, "pres_pen": 0.5},
             {"logit_bias": ((65, 5.0), (66, -100.0))}]

    async def run(engine):
        await engine.start()
        try:
            async def one(i):
                evs = [ev async for ev in engine.generate(
                    list(b"abc %d" % i) * 2, max_new_tokens=5 + i, logprobs=2,
                    **extra[i % 3])]
                return [(ev.token_id, ev.logprob) for ev in evs]
            return await asyncio.gather(*[one(i) for i in range(6)])
        finally:
            await engine.stop()

    want = asyncio.run(run(JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE),
                                            params=jp)))
    got = asyncio.run(run(InferenceEngine(engine_cfg=EngineConfig(**ENGINE),
                                          params=tp, device="cpu")))
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([lp for _, lp in g if lp is not None],
                                   [lp for _, lp in w if lp is not None],
                                   atol=1e-4)


def test_construction_guards():
    with pytest.raises(NotPorted, match="ROADMAP"):
        InferenceEngine(engine_cfg=EngineConfig(**ENGINE, mux=True), device="cpu")
    with pytest.raises(NotPorted, match="ROADMAP"):
        InferenceEngine(engine_cfg=EngineConfig(**ENGINE, kv_quant="int8"),
                        device="cpu")
    if not torch.cuda.is_available():
        # No card and no explicit CPU request: never run on the CPU quietly.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(engine_cfg=EngineConfig(**ENGINE))


def test_unported_endpoints_answer_typed_errors(weights):
    _, tp = weights
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE), params=tp,
                             device="cpu")

    async def run():
        async with _stack(engine, engine_backend, run_serve, run_proxy,
                          loopback_pair) as base:
            resp = await http11.http_request(
                "POST", base + "/v1/embeddings", {},
                json.dumps({"input": "hello"}).encode(), timeout=30.0)
            return resp.status, await resp.read_all()

    status, body = asyncio.run(run())
    assert status == 502 and b"not ported" in body
