"""The system under test, assembled in the benchmark's process.

The port's real serving path, as ``testing/local_stack.py`` assembles it:
``InferenceEngine`` -> ``engine_backend`` -> ``run_serve`` over one end of
``loopback_pair`` and ``run_proxy`` over the other, listening on
127.0.0.1.  The engine is built from a configuration file's ``engine``
section (``EngineConfig`` fields), the port's preset named by ``preset``
with every published size of the file laid over it (as the fields its
architecture maps them to: ``benchmark/arch/<name>.py`` ``model_fields``),
the benchmark's own weights, and ``NumericTokenizer`` over the whole
vocabulary, so every served id crosses the tunnel as the text ``"<id> "``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.transport.loopback import loopback_pair

from benchmark import arch


def model_config(cfg: Dict):
    """The port's ModelConfig for a configuration file: its preset with
    every size the file states."""
    return get_config(cfg["preset"], **arch.for_config(cfg).model_fields(cfg))


def build_engine(cfg: Dict, params, device) -> InferenceEngine:
    """The engine of a configuration file on ``device``, serving
    ``params``; raises when it fenced off any flag the file names."""
    mcfg = model_config(cfg)
    engine = InferenceEngine(
        model_cfg=mcfg,
        engine_cfg=EngineConfig(model=cfg["preset"], **cfg["engine"]),
        params=params,
        tokenizer=NumericTokenizer(vocab_size=mcfg.vocab_size),
        device=device,
    )
    fenced = [f for f in engine.config_fences if f["knob"] in cfg["engine"]]
    if fenced:
        raise RuntimeError(f"the engine fenced flags the configuration "
                           f"names: {fenced}")
    return engine


class Stack:
    """serve and proxy over a loopback tunnel in front of one engine."""

    def __init__(self, engine: InferenceEngine, max_inflight: int):
        self.engine = engine
        self.max_inflight = max_inflight
        self.port: Optional[int] = None
        self._tasks: List[asyncio.Task] = []

    async def start(self) -> int:
        serve_ch, proxy_ch = loopback_pair()
        serve = asyncio.create_task(run_serve(
            serve_ch, backend=engine_backend(self.engine, "bench"),
            max_inflight=self.max_inflight,
        ))
        ready: asyncio.Future = asyncio.get_running_loop().create_future()
        proxy = asyncio.create_task(run_proxy(
            proxy_ch, "127.0.0.1", 0, ready=ready, tenant_fallback="bench",
        ))
        self._tasks = [serve, proxy]
        await asyncio.wait({ready, proxy}, return_when=asyncio.FIRST_COMPLETED)
        if not ready.done():
            proxy.result()
            raise RuntimeError("proxy exited before reporting readiness")
        self.port = ready.result()
        return self.port

    def alive(self) -> Tuple[bool, str]:
        for t in self._tasks:
            if t.done():
                exc = None if t.cancelled() else t.exception()
                return False, f"{t.get_coro().__name__} ended: {exc!r}"
        return True, ""

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.engine.stop()
