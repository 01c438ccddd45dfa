"""PyTorch/CUDA port of the P2P LLM tunnel.

The second package beside ``p2p_llm_tunnel_tpu`` (the JAX/TPU reference it
is held against by ``tests/test_torch_*.py``).  The tunnel plane —
``protocol``, ``signaling``, ``transport``, ``endpoints``, the engine's
HTTP API, scheduler and tokenizers, ``utils`` — is a copy of the
reference's host modules: the code is verbatim with the import paths
rewritten; only comments and help texts lost their citations of the
reference's development history.  The compute side is PyTorch:

- ``models``  — llama/gemma-family decoder in plain torch (bf16 weights,
  raw bf16 KV cache written in place)
- ``ops``     — rope, norms, plain attention, and the two hand-written
  Hopper kernels (``csrc/``) that replace the TPU's Pallas prefill and
  decode attention kernels
- ``engine``  — the continuous-batching engine (non-mux path), sampling

This package imports ``torch`` and never ``jax``, nor anything of
``p2p_llm_tunnel_tpu``.  Entry points run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"`` / ``--device cpu``).

CLI: ``python -m p2p_llm_tunnel_tpu_torch.cli serve|proxy|signal``.
"""

__version__ = "0.1.0"
