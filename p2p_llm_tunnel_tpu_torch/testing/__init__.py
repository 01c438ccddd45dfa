"""Test fixtures usable both from pytest and from integration scripts."""

from p2p_llm_tunnel_tpu_torch.testing.mock_llm import create_mock_llm_handler

__all__ = ["create_mock_llm_handler"]
