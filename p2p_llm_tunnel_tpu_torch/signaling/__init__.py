"""Rendezvous signaling: WebSocket rooms where two peers exchange
session-descriptor/candidate messages before going peer-to-peer.

Server semantics match signal-server/src/index.ts (rooms of 2, verbatim
relay, peer-left notification); client semantics match
tunnel/src/signaling.rs (join-on-connect, reader/writer tasks, bye-on-close).
"""

from p2p_llm_tunnel_tpu_torch.signaling.client import SignalingClient
from p2p_llm_tunnel_tpu_torch.signaling.server import SignalServer

__all__ = ["SignalingClient", "SignalServer"]
