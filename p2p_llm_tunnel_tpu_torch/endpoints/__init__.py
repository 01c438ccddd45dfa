"""Tunnel application endpoints.

- ``serve``  — provider side: frames in, upstream (HTTP or in-process TPU
  engine) out, streaming response frames back (reference tunnel/src/serve.rs).
- ``proxy``  — consumer side: local HTTP/1.1 listener, frames out, streaming
  HTTP responses back (reference tunnel/src/proxy.rs).
- ``http11`` — from-scratch asyncio HTTP/1.1 server + streaming client (the
  reference leans on hyper/reqwest; we keep the runtime dependency-free).
"""

from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy

__all__ = ["run_serve", "run_proxy"]
