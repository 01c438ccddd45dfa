"""Shared utilities: env-filtered logging and observability counters."""

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger, init_logging
from p2p_llm_tunnel_tpu_torch.utils.metrics import Metrics, global_metrics

__all__ = ["get_logger", "init_logging", "Metrics", "global_metrics"]
