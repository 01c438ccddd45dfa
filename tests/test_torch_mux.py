"""The port's serve-default engine — mux, prefix pool and conversation
cache — against the JAX engine in the same configuration, on the CPU.

Both engines run the tiny model at fp32 on the same weights (JAX
``init_params``, bridged with ``params_from_numpy``), each behind its own
package's tunnel stack (``loopback_pair`` + ``run_serve`` + ``run_proxy``),
driven with real HTTP.  The traffic is a two-turn conversation mix: more
conversations than slots, every first turn sharing a system prompt of
several pool pages and longer than ``prefill_chunk`` (several segments),
alternating SSE ``/v1/completions`` (token-id prompts) and NDJSON
``/api/generate``; every second turn resends its first turn plus the
answer plus a new tail.  ``NumericTokenizer`` renders each id as text, so
the client reads the answer's ids back exactly.  Greedy streams must be
byte-identical, with the port's ``ragged_prefill`` off and on (the JAX
engine runs with it off: tests/test_ragged_prefill.py pins JAX's ragged ≡
chunked).  The weight seed is tie-free for this traffic.

The quantized caches run the same traffic: int8 on the serve defaults,
int4 with the port's fused decode layer and ragged prefill on the serve
defaults, and int4 on the non-mux loop — against the JAX engine at the
same ``kv_quant``, unfused and without ragged prefill (the JAX package
pins fused ≡ unfused and ragged ≡ chunked at every KV form:
tests/test_fused_decode_layer.py, tests/test_ragged_prefill.py).
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
from p2p_llm_tunnel_tpu.engine.tokenizer import NumericTokenizer as JNumeric
from p2p_llm_tunnel_tpu.models.config import get_config
from p2p_llm_tunnel_tpu.models.transformer import init_params
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu.utils.metrics import global_metrics as j_metrics
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

ENGINE = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32",
              decode_steps=4, mux=True, prefix_cache=True, conv_cache=True,
              prefill_chunk=32)
WEIGHT_SEED = 3  # tie-free for the traffic below
SYSTEM = b"You are the tunnel's terse assistant; reply in numbers only. "
N_CONV = 6  # > num_slots: admissions wait and land mid-decode
COUNTERS = ("engine_prefix_hit_tokens_total", "engine_prefix_dedup_hits_total",
            "engine_conv_saved_pages_total")


@pytest.fixture(scope="module")
def weights():
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
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


async def _turn(base: str, prompt_ids, max_tokens: int, ndjson: bool):
    """One streamed request; returns (generated ids, finish reason)."""
    if ndjson:
        path, sep = "/api/generate", b"\n"
        body = {"prompt": bytes(prompt_ids).decode("ascii"),
                "max_new_tokens": max_tokens, "ignore_eos": True}
    else:
        path, sep = "/v1/completions", b"\n\n"
        body = {"prompt": list(prompt_ids), "max_tokens": max_tokens,
                "stream": True, "ignore_eos": True}
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=120.0,
    )
    assert resp.status == 200
    raw = await resp.read_all()
    text, last = "", None
    for line in raw.split(sep):
        line = line.strip()
        if not line or line == b"data: [DONE]":
            continue
        if line.startswith(b"data: "):
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            text += choice.get("text") or ""
            last = choice.get("finish_reason") or last
        else:
            obj = json.loads(line)
            text += obj.get("response", "")
            last = obj.get("done_reason") or last
    return [int(t) for t in text.split()], last


def _first_turns():
    return [list(SYSTEM) + list(f"question {i}: ".encode() * (2 + i))
            for i in range(N_CONV)]


async def _conversations(base: str):
    """N_CONV concurrent first turns, then N_CONV concurrent second turns
    that resend turn 1 + its answer + a new tail."""
    firsts = _first_turns()
    one = await asyncio.gather(*[
        _turn(base, p, 20 + i, ndjson=i % 2 == 1) for i, p in enumerate(firsts)
    ])
    seconds = [p + ids + list(b" and then?") for p, (ids, _) in zip(firsts, one)]
    two = await asyncio.gather(*[
        _turn(base, p, 6, ndjson=False) for p in seconds
    ])
    return one + two


def _counters(metrics):
    return {name: metrics.counter(name) for name in COUNTERS}


def _drive(engine, backend, serve, proxy, pair, metrics):
    async def run():
        async with _stack(engine, backend, serve, proxy, pair) as base:
            return await _conversations(base)

    before = _counters(metrics)
    out = asyncio.run(run())
    after = _counters(metrics)
    return out, {k: after[k] - before[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def jax_streams(weights):
    jp, _ = weights
    return _drive(
        JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE), params=jp,
                         tokenizer=JNumeric()),
        j_engine_backend, j_run_serve, j_run_proxy, j_loopback_pair, j_metrics,
    )


@pytest.mark.parametrize("ragged", [False, True])
def test_serve_default_streams_byte_identical_to_jax(weights, jax_streams, ragged):
    _, tp = weights
    want, j_deltas = jax_streams
    engine = InferenceEngine(
        engine_cfg=EngineConfig(**ENGINE, ragged_prefill=ragged), params=tp,
        tokenizer=NumericTokenizer(), device="cpu")
    got, deltas = _drive(engine, engine_backend, run_serve, run_proxy,
                         loopback_pair, global_metrics)
    assert got == want
    assert all(len(ids) == n for (ids, _), n in zip(
        got, [20 + i for i in range(N_CONV)] + [6] * N_CONV))
    assert {finish for _, finish in got} == {"length"}
    for name in COUNTERS:
        assert deltas[name] > 0, (name, deltas)
        assert j_deltas[name] > 0, (name, j_deltas)
    # Every second turn reached past its first turn's prompt pages into
    # the answer's conversation-cache pages.
    assert engine._prefix.conv_hits >= N_CONV
    # The leak gate: every page reserved at admission was released.
    assert engine._page_reserved == {}
    assert engine._prefix.reserved_pages == 0
    assert engine.ecfg.ragged_prefill == ragged and engine.config_fences == []


#: (port engine knobs, JAX engine knobs) per quantized configuration.
QUANT_CASES = {
    "int8-defaults": (dict(kv_quant="int8"), dict(kv_quant="int8")),
    "int4-fused-ragged": (
        dict(kv_quant="int4", fused_decode_layer=True, ragged_prefill=True),
        dict(kv_quant="int4")),
    "int4-no-mux": (
        dict(kv_quant="int4", mux=False, prefill_chunk=0),
        dict(kv_quant="int4", mux=False, prefill_chunk=0)),
}
_JAX_QUANT = {}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_streams_byte_identical_to_jax(weights, case):
    jp, tp = weights
    port_kw, jax_kw = QUANT_CASES[case]
    if case not in _JAX_QUANT:
        _JAX_QUANT[case] = _drive(
            JInferenceEngine(engine_cfg=JEngineConfig(**dict(ENGINE, **jax_kw)),
                             params=jp, tokenizer=JNumeric()),
            j_engine_backend, j_run_serve, j_run_proxy, j_loopback_pair,
            j_metrics)
    want, _ = _JAX_QUANT[case]
    engine = InferenceEngine(
        engine_cfg=EngineConfig(**dict(ENGINE, **port_kw)), params=tp,
        tokenizer=NumericTokenizer(), device="cpu")
    got, deltas = _drive(engine, engine_backend, run_serve, run_proxy,
                         loopback_pair, global_metrics)
    assert got == want
    assert {finish for _, finish in got} == {"length"}
    assert engine.config_fences == []
    assert engine.mcfg.fused_decode_layer == port_kw.get("fused_decode_layer", False)
    assert tt.kv_cache_quant_mode(engine.kv_cache) == port_kw["kv_quant"]
    if engine.ecfg.prefix_cache:
        assert deltas["engine_prefix_hit_tokens_total"] > 0
        packed = port_kw["kv_quant"] == "int4"
        assert engine._pool["k"].shape[2] == (8 if packed else 16)
        assert engine._page_reserved == {} and engine._prefix.reserved_pages == 0


def _herd(params, prompts, max_new=6, **kw):
    cfg = dict(ENGINE, conv_cache=False)
    cfg.update(kw)
    engine = InferenceEngine(engine_cfg=EngineConfig(**cfg), params=params,
                             device="cpu")

    async def run():
        await engine.start()
        try:
            async def one(p):
                return [ev.token_id async for ev in engine.generate(
                    p, max_new_tokens=max_new, stop_ids=())]
            return await asyncio.gather(*[one(p) for p in prompts])
        finally:
            await engine.stop()

    return asyncio.run(run()), engine


HERD = [list(SYSTEM) + [200 + i] * (5 + 7 * i) for i in range(5)]


@pytest.mark.parametrize("knob,off,on", [
    ("mux", dict(mux=False, prefix_cache=False), dict(prefix_cache=False)),
    ("prefix_cache", dict(prefix_cache=False), {}),
    ("ragged_prefill", {}, dict(ragged_prefill=True)),
])
def test_port_knob_on_off_identity(weights, knob, off, on):
    """mux on/off, pool on/off and ragged on/off are pure scheduling /
    latency choices in the port: byte-identical greedy streams at the same
    segment width (as tests/test_mux.py and tests/test_paged_pool.py pin
    for the reference)."""
    _, tp = weights
    want, _ = _herd(tp, HERD, **off)
    got, engine = _herd(tp, HERD, **on)
    assert got == want
    if knob == "prefix_cache":
        assert engine._prefix.hits > 0


@pytest.mark.parametrize("ragged", [False, True])
def test_plain_loop_cached_wave_identity(weights, ragged):
    """The non-mux loop with the pool: later requests sharing the system
    prompt's pages take the cached-wave route (pool copy-in, then a tail
    through the chunk path or, with ragged on, the ragged kernel's plain
    version) and stream exactly what the pool-free loop streams."""
    _, tp = weights
    prompts = [list(SYSTEM) + [200 + i] * (5 + 3 * i) for i in range(4)]

    def run(**kw):
        engine = InferenceEngine(engine_cfg=EngineConfig(**dict(
            ENGINE, mux=False, conv_cache=False, prefill_chunk=0, **kw)),
            params=tp, device="cpu")
        dispatches = []
        if engine.ecfg.ragged_prefill:
            ragged_rows = engine._dispatch_ragged_rows
            engine._dispatch_ragged_rows = (
                lambda rows: dispatches.append(len(rows)) or ragged_rows(rows))

        async def go():
            await engine.start()
            try:
                return [await _collect(engine, p, 6) for p in prompts]
            finally:
                await engine.stop()

        return asyncio.run(go()), engine, dispatches

    want, _, _ = run(prefix_cache=False)
    got, engine, dispatches = run(prefix_cache=True, ragged_prefill=ragged)
    assert got == want
    assert engine._prefix.hits == len(prompts) - 1
    assert bool(dispatches) == ragged


def test_leak_gate_after_cancel_and_deadline(weights):
    """Pages reserved at admission return on every death path: a client
    cancel mid-stream and an owner cancelled while its waiter is parked."""
    _, tp = weights
    engine = InferenceEngine(engine_cfg=EngineConfig(**dict(ENGINE, num_slots=2)),
                             params=tp, device="cpu")
    shared = list(SYSTEM) + list(range(1, 40))

    async def run():
        await engine.start()
        try:
            gen = engine.generate(shared + [98], max_new_tokens=64, stop_ids=())
            async for _ in gen:
                break
            await gen.aclose()
            owner = engine.generate(shared + [97], max_new_tokens=8, stop_ids=())
            waiter = asyncio.create_task(_collect(engine, shared + [96], 4))
            task = asyncio.create_task(owner.__aiter__().__anext__())
            await asyncio.sleep(0)
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
            await owner.aclose()
            assert len(await waiter) == 4
            await asyncio.sleep(0.2)
        finally:
            await engine.stop()

    asyncio.run(run())
    assert engine._page_reserved == {}
    assert engine._prefix.reserved_pages == 0
    assert (engine._prefix.used_blocks + engine._prefix.free_blocks
            == engine.ecfg.prefix_pool_blocks - 1)


async def _collect(engine, prompt, n):
    return [ev.token_id async for ev in engine.generate(
        prompt, max_new_tokens=n, stop_ids=())]


def test_conv_insert_enqueued_before_the_slot_is_prefilled_again(weights):
    """A finished conversation's pages are copied into the pool on the
    executor BEFORE the next admission's prefill into the same slot is
    dispatched (one slot, a second request queued behind the first); the
    pooled pages then hold the first conversation's KV, not the second's."""
    _, tp = weights
    engine = InferenceEngine(
        engine_cfg=EngineConfig(**dict(ENGINE, num_slots=1)), params=tp,
        device="cpu")
    order = []
    conv_insert, chunk_rows = engine._conv_insert, engine._dispatch_chunk_rows

    def rec_conv(pending):
        order.append(("conv", [slot for slot, _ in pending]))
        return conv_insert(pending)

    def rec_chunk(rows, t):
        order.append(("prefill", [run.request.request_id for run, *_ in rows]))
        return chunk_rows(rows, t)

    engine._conv_insert, engine._dispatch_chunk_rows = rec_conv, rec_chunk
    first = list(SYSTEM) + list(range(1, 30))
    second = [250 - i for i in range(70)]

    async def run():
        await engine.start()
        try:
            return await asyncio.gather(_collect(engine, first, 24),
                                        _collect(engine, second, 4))
        finally:
            await engine.stop()

    out_a, _ = asyncio.run(run())
    conv_at = order.index(("conv", [0]))
    second_at = next(i for i, (kind, who) in enumerate(order)
                     if kind == "prefill" and 2 in who)
    assert conv_at < second_at, order
    # The conversation's pages hold ITS KV: equal to a fresh prefill of
    # the same tokens (decode-computed rows differ only by fp32 rounding).
    seq = first + out_a[:-1]
    hist, ids = engine._prefix.match(seq + [0])
    assert hist == len(seq) // 16 * 16
    cfg = engine.mcfg
    ref = tt.init_kv_cache(cfg, 1, 256, torch.float32, device="cpu")
    tt.prefill_into_cache(cfg, tp, torch.tensor([seq]), torch.tensor([len(seq)]),
                          ref, torch.tensor([0]))
    for j, pid in enumerate(ids):
        np.testing.assert_allclose(
            engine._pool["k"][:, pid].numpy(),
            ref["k"][:, 0, j * 16:(j + 1) * 16].numpy(), atol=1e-4, rtol=1e-4)


def test_ragged_fenced_on_misaligned_geometry():
    engine = InferenceEngine(
        engine_cfg=EngineConfig(model="tiny", num_slots=2, max_seq=128,
                                dtype="float32", prefill_chunk=100,
                                ragged_prefill=True), device="cpu")
    assert engine.ecfg.ragged_prefill is False
    assert any(f["knob"] == "ragged_prefill" for f in engine.config_fences)


def test_mux_defaults_chunk_and_geometry():
    engine = InferenceEngine(
        engine_cfg=EngineConfig(model="tiny", num_slots=8, max_seq=512,
                                dtype="float32", mux=True, prefix_cache=True,
                                ragged_prefill=True), device="cpu")
    assert engine.ecfg.prefill_chunk == 128
    assert (engine._ragged_bq, engine._ragged_tot,
            engine._ragged_row_blocks) == (16, 1024, 8)
    assert engine._prefix is not None and engine.scheduler.page_reserve
