"""The in-process PyTorch inference engine (port of
p2p_llm_tunnel_tpu/engine, the non-mux serving path): prefill waves and
pipelined decode bursts over a slot-based KV cache, continuous batching,
and the OpenAI/Ollama-shaped streaming APIs (``api.py``, a copy).
"""

from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend

__all__ = ["EngineConfig", "InferenceEngine", "engine_backend"]
