"""Data-parallel replica routing: fan requests across engine replicas
(port of p2p_llm_tunnel_tpu/engine/router.py).

Each replica is one InferenceEngine (its own slots and KV cache, typically
its own card); the router admits each request to the least-loaded replica,
so concurrent streams from one or many proxy peers spread across every
card.  Placing the replicas is the caller's job (``tunnel-gpu serve
--replicas N`` puts replica i on ``cuda:(i % device_count)`` with
``seed=i``); the router itself is pure dispatch policy.
"""

from __future__ import annotations

from typing import List, Optional

from p2p_llm_tunnel_tpu_torch.engine.api import EngineAPI
from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
from p2p_llm_tunnel_tpu_torch.protocol.frames import RequestHeaders
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class ReplicaRouter:
    """Least-loaded dispatch over N engine replicas."""

    def __init__(self, engines: List[InferenceEngine],
                 model_name: Optional[str] = None):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = engines
        self.apis = [EngineAPI(e, model_name) for e in engines]
        self._rr = 0

    def _load(self, engine: InferenceEngine) -> float:
        sched = engine.scheduler
        return sched.queue_depth + sched.occupancy * sched.num_slots

    def pick(self) -> int:
        """Least-loaded replica; round-robin tiebreak so idle replicas all
        see traffic (and stay warm) under light load."""
        loads = [self._load(e) for e in self.engines]
        low = min(loads)
        candidates = [i for i, l in enumerate(loads) if l == low]
        self._rr = (self._rr + 1) % len(candidates)
        return candidates[self._rr % len(candidates)]

    async def start(self) -> None:
        for e in self.engines:
            await e.start()

    async def stop(self) -> None:
        for e in self.engines:
            await e.stop()

    async def handle(self, req: RequestHeaders, body: bytes):
        idx = self.pick()
        log.debug("routing stream %d to replica %d", req.stream_id, idx)
        return await self.apis[idx].handle(req, body)


def router_backend(router: ReplicaRouter):
    """Adapter: ReplicaRouter as a serve-endpoint Backend (``.router``
    holds the router, as ``engine_backend`` exposes its engine's hooks)."""

    async def backend(req: RequestHeaders, body: bytes):
        return await router.handle(req, body)

    backend.router = router
    return backend
