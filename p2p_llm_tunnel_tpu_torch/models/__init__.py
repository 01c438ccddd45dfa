"""Model families: decoder-only transformers in plain PyTorch (port of
p2p_llm_tunnel_tpu/models, the subset the serving path runs)."""

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig, PRESETS, get_config
from p2p_llm_tunnel_tpu_torch.models.transformer import (
    init_params,
    prefill,
    decode_step,
    init_kv_cache,
)

__all__ = [
    "ModelConfig",
    "PRESETS",
    "get_config",
    "init_params",
    "prefill",
    "decode_step",
    "init_kv_cache",
]
