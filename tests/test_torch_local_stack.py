"""The port's loopback stack twin, ``p2p_llm_tunnel_tpu_torch.testing.
local_stack``, spawned as a process on the CPU and driven from outside.

- ``scripts/loadgen.py --port`` drives it as it drives the JAX module's
  stack: a herd of streams, ``--turns 2`` on the prefix pool and on the
  two-engine ``--disagg`` fabric (KV pages shipped from the prefill peer
  to the decode peer), each run with loadgen's exit 0 (no stuck stream, no
  leaked slot, page, stream or transfer).
- Its greedy streams, single engine and ``--disagg``, are byte-identical
  to the JAX engine's on the twin's own weights (the port's ``init_params``
  from the EngineConfig seed, bridged into JAX), each engine behind its
  package's tunnel in the same configuration.
- ``_peer_chaos`` wraps the named peer only, as the JAX module's; a taken
  port exits non-zero with no readiness line, and so does a stack with
  no card and no ``--device cpu``.  SIGTERM stops the stack with exit 0.
"""

import asyncio
import contextlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from p2p_llm_tunnel_tpu.endpoints.proxy import run_proxy as j_run_proxy
from p2p_llm_tunnel_tpu.endpoints.serve import run_serve as j_run_serve
from p2p_llm_tunnel_tpu.engine.api import engine_backend as j_engine_backend
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.engine.tokenizer import Latin1Tokenizer as JLatin1
from p2p_llm_tunnel_tpu.transport import loopback_pair as j_loopback_pair
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.models.transformer import init_params
from p2p_llm_tunnel_tpu_torch.testing import local_stack
from p2p_llm_tunnel_tpu_torch.transport import chaos, loopback_pair
from torch_tp_ranks import tunnel_stack

REPO = Path(__file__).resolve().parent.parent
STACK = ["--device", "cpu", "--model", "tiny", "--slots", "4", "--max-seq", "128"]
READY_S = 120.0


@contextlib.contextmanager
def spawned(log_path: Path, *flags):
    """The twin as a process with ``STACK`` + ``flags``; yields its port
    once it printed the readiness line, then SIGTERMs it and requires a
    clean exit."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "p2p_llm_tunnel_tpu_torch.testing.local_stack",
             "--port", "0", *STACK, *flags],
            stdout=subprocess.PIPE, stderr=log, text=True, cwd=REPO)
    try:
        deadline, port = time.monotonic() + READY_S, None
        while port is None and time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [],
                                        max(0.1, deadline - time.monotonic()))
            line = proc.stdout.readline() if ready else ""
            if not line:
                break
            if line.startswith(local_stack.READY_PREFIX):
                port = int(line.strip().split("=", 1)[1])
        assert port is not None, log_path.read_text()[-3000:]
        yield port
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, log_path.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()


def loadgen(port: int, *flags) -> dict:
    """``scripts/loadgen.py --port P ... --json`` against the twin; its
    report, after requiring exit 0 (no stuck stream, nothing leaked)."""
    out = subprocess.run(
        [sys.executable, "scripts/loadgen.py", "--port", str(port), "--json",
         "--ramp", "0.2", *flags],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


async def _request(base: str, i: int):
    """One greedy streamed request (SSE chat or NDJSON generate); its
    content bytes and finish reason."""
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
        json.dumps(body).encode(), timeout=120.0)
    assert resp.status == 200
    out, last = [], None
    for line in (await resp.read_all()).split(sep):
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


#: The requests whose greedy streams are compared.  Request 1's third
#: token is a tie at bf16 on the twin's weights: its top-2 logits are
#: 2.1719 / 2.1719 in the port's forward and 2.1875 / 2.1719 in JAX's (one
#: bf16 step apart at that magnitude; the two forwards' logits differ by
#: up to ~0.03 there), so either argmax is right and the streams part.
TIE_FREE = (0, 2, 3, 4, 5)


async def _streams(base: str):
    return await asyncio.gather(*[_request(base, i) for i in TIE_FREE])


def _twin_streams(port: int):
    return asyncio.run(_streams(f"http://127.0.0.1:{port}"))


@pytest.fixture(scope="module")
def jax_weights():
    """The twin's weights (the port's init from EngineConfig seed 0 at
    bf16, as ``tunnel-gpu serve`` draws them), as a JAX tree."""
    tree = init_params(get_config("tiny", vocab_size=259), 0, torch.bfloat16, "cpu")

    def to_jax(x):
        if isinstance(x, dict):
            return {k: to_jax(v) for k, v in x.items()}
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    return to_jax(tree)


def _jax_streams(weights, prefix_cache: bool):
    """The JAX engine in the twin's configuration (``local_stack``'s
    EngineConfig fields, the engine defaults otherwise) behind the JAX
    package's tunnel; the same requests as the twin's."""
    engine = JInferenceEngine(
        engine_cfg=JEngineConfig(
            model="tiny", num_slots=4, max_seq=128, decode_steps=8,
            max_waiting=600, fair_admission=True, tenant_weights="", mux=True,
            prefix_cache=prefix_cache, conv_cache=prefix_cache,
            prefix_pool_blocks=128, spill_pages=0, watchdog_budget_s=120.0),
        params=weights, tokenizer=JLatin1() if prefix_cache else None)

    async def run():
        async with tunnel_stack(engine, j_engine_backend, j_run_serve,
                                j_run_proxy, j_loopback_pair) as base:
            return await _streams(base)

    return asyncio.run(run())


def test_loadgen_herd_and_streams_on_the_twin(tmp_path, jax_weights):
    with spawned(tmp_path / "stack.log") as port:
        report = loadgen(port, "--tenant", "herd:8:2", "--max-tokens", "8")
        got = _twin_streams(port)
    (herd,) = report["tenants"]
    assert (herd["requests"], herd["ok"], herd["stuck"]) == (16, 16, 0)
    assert report["healthz_after"]["status"] == "ok"
    assert got == _jax_streams(jax_weights, prefix_cache=False)
    assert all(text for text, _ in got)


def test_prefix_cache_turns_on_the_twin(tmp_path):
    with spawned(tmp_path / "stack.log", "--prefix-cache") as port:
        report = loadgen(port, "--tenant", "conv:4", "--turns", "2",
                         "--max-tokens", "8")
    (conv,) = report["tenants"]
    assert (conv["requests"], conv["ok"]) == (8, 8)
    one, two = report["turns"]
    # Turn 2 resends turn 1 and its answer: the conversation cache serves
    # it, and only the new tails are prefilled.
    assert two["conv_hits"] > 0
    assert two["prefill_tokens"] < two["prompt_tokens_sent"]


def test_disagg_fabric_ships_pages_and_streams_equal_jax(tmp_path, jax_weights):
    with spawned(tmp_path / "stack.log", "--disagg") as port:
        report = loadgen(port, "--tenant", "conv:4", "--turns", "2",
                         "--max-tokens", "8")
        got = _twin_streams(port)
    (conv,) = report["tenants"]
    assert (conv["requests"], conv["ok"]) == (8, 8)
    assert report["disagg"]["engine_pages_shipped"] >= 1
    assert report["disagg"]["proxy_disagg_fallbacks"] == 0
    assert got == _jax_streams(jax_weights, prefix_cache=True)


@pytest.mark.parametrize("target", ["", "prefill-0", "decode-0"])
def test_peer_chaos_wraps_only_the_named_peer(target, monkeypatch):
    from p2p_llm_tunnel_tpu.testing import local_stack as j_local_stack

    monkeypatch.setenv("TUNNEL_CHAOS", "seed=7,drop=0.1")
    monkeypatch.setenv("TUNNEL_CHAOS_PEER", target)
    for pid in ("prefill-0", "decode-0"):
        ch, _ = loopback_pair()
        jch, _ = j_loopback_pair()
        wrapped = local_stack._peer_chaos(ch, pid)
        assert (wrapped is not ch) == (target in ("", pid))
        assert (wrapped is not ch) == (j_local_stack._peer_chaos(jch, pid) is not jch)
        if wrapped is not ch:
            assert isinstance(wrapped, chaos.ChaosChannel)


def _exits_without_ready(flags, env, timeout=120):
    out = subprocess.run(
        [sys.executable, "-m", "p2p_llm_tunnel_tpu_torch.testing.local_stack",
         *flags], capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=env)
    assert out.returncode != 0
    assert local_stack.READY_PREFIX not in out.stdout
    return out.stderr


def test_taken_port_exits_nonzero():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        port = blocker.getsockname()[1]
        _exits_without_ready(["--port", str(port), *STACK], dict(os.environ))
    finally:
        blocker.close()


def test_no_card_and_no_device_flag_exits_nonzero():
    """The engines run on the card unless ``--device cpu`` asks for the
    CPU: with no card visible the stack refuses before serving."""
    env = {k: v for k, v in os.environ.items() if k != "TUNNEL_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    err = _exits_without_ready(["--port", "0", "--model", "tiny"], env)
    assert "no CUDA device" in err
