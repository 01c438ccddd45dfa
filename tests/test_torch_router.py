"""The port's data-parallel replica router (``engine/router.py``), mirroring
tests/test_router.py: least-loaded dispatch with a round-robin tiebreak,
requests spread across replicas, and ``serve --replicas 2`` building the
replicas the JAX CLI builds (seed i, its own snapshot subdirectory) behind
one tunnel."""

import asyncio
import json
import os

import pytest

from p2p_llm_tunnel_tpu import cli as j_cli
from p2p_llm_tunnel_tpu_torch import cli
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.router import ReplicaRouter, router_backend
from p2p_llm_tunnel_tpu_torch.engine.scheduler import GenRequest
from p2p_llm_tunnel_tpu_torch.protocol.frames import RequestHeaders
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair


async def _sse_stream(base: str, i: int, max_tokens: int):
    """One streamed /v1/completions request (byte-level tokenizer: the
    text may be empty); (token events, finish reason)."""
    body = {"prompt": f"replica stream {i}", "max_tokens": max_tokens,
            "stream": True, "ignore_eos": True}
    resp = await http11.http_request(
        "POST", base + "/v1/completions", {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=60.0)
    assert resp.status == 200
    events, finish = 0, None
    for line in (await resp.read_all()).split(b"\n\n"):
        line = line.strip()
        if line.startswith(b"data: ") and line != b"data: [DONE]":
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            events += choice.get("finish_reason") is None
            finish = choice.get("finish_reason") or finish
    return events, finish


def _engines(n):
    return [InferenceEngine(engine_cfg=EngineConfig(
        model="tiny", num_slots=2, max_seq=64, dtype="float32", decode_steps=2,
        seed=i), device="cpu") for i in range(n)]


def _count_generates(engines):
    counts = [0] * len(engines)
    for i, e in enumerate(engines):
        gen = e.generate

        def counted(*a, _i=i, _gen=gen, **kw):
            counts[_i] += 1
            return _gen(*a, **kw)

        e.generate = counted
    return counts


def test_pick_round_robins_when_idle():
    router = ReplicaRouter(_engines(3))
    assert {router.pick() for _ in range(9)} == {0, 1, 2}


def test_pick_prefers_least_loaded():
    engines = _engines(2)
    router = ReplicaRouter(engines)
    engines[0].scheduler.submit(GenRequest(1, [1, 2], 4))
    engines[0].scheduler.submit(GenRequest(2, [1, 2], 4))
    assert all(router.pick() == 1 for _ in range(5))


def test_router_needs_a_replica():
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])


def test_requests_spread_across_replicas():
    engines = _engines(2)
    counts = _count_generates(engines)

    async def main():
        router = ReplicaRouter(engines, "tiny")
        await router.start()
        try:
            async def one(i):
                req = RequestHeaders(i, "POST", "/v1/completions", {})
                body = json.dumps({"prompt": f"spread {i}", "max_tokens": 6,
                                   "ignore_eos": True}).encode()
                status, _headers, chunks = await router.handle(req, body)
                assert status == 200
                async for _ in chunks:
                    pass

            await asyncio.gather(*(one(i) for i in range(1, 7)))
        finally:
            await router.stop()

    asyncio.run(asyncio.wait_for(main(), 120))
    assert all(c > 0 for c in counts) and sum(counts) == 6


def test_serve_replicas_builds_the_jax_cli_replicas(tmp_path, monkeypatch):
    """``tunnel-gpu serve --replicas 2`` (the JAX CLI's flag and env name):
    replica i has seed i and snapshots into ``replica-i/``; both take
    streams through one tunnel."""
    monkeypatch.setenv("TUNNEL_REPLICAS", "2")
    argv = ["serve", "--model", "tiny", "--slots", "2", "--max-seq", "128",
            "--dtype", "float32", "--room", "r", "--prefix-cache-dir",
            str(tmp_path)]
    args = cli.build_parser().parse_args(argv + ["--backend", "gpu", "--device", "cpu"])
    jargs = j_cli.build_parser().parse_args(argv + ["--backend", "tpu"])
    assert args.replicas == jargs.replicas == 2

    async def run():
        backend = await cli._engine_backend(args)
        router = backend.router
        engines = router.engines
        counts = _count_generates(engines)
        serve_ch, proxy_ch = loopback_pair()
        ready = asyncio.get_running_loop().create_future()
        tasks = [asyncio.create_task(run_serve(serve_ch, backend=router_backend(router))),
                 asyncio.create_task(run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))]
        try:
            base = f"http://127.0.0.1:{await asyncio.wait_for(ready, 10.0)}"
            outs = await asyncio.gather(*[_sse_stream(base, i, 4) for i in range(6)])
        finally:
            for t in tasks:
                t.cancel()
            serve_ch.close()
            await asyncio.gather(*tasks, return_exceptions=True)
            await router.stop()
            cli._BACKEND = None
        return engines, counts, outs

    engines, counts, outs = asyncio.run(asyncio.wait_for(run(), 120))
    assert [e.ecfg.seed for e in engines] == [0, 1]
    assert [e.ecfg.prefix_cache_dir for e in engines] == [
        os.path.join(str(tmp_path), f"replica-{i}") for i in range(2)]
    assert all(e.device.type == "cpu" for e in engines)
    assert all(c > 0 for c in counts)
    assert all(fin == "length" for _, fin in outs), outs
