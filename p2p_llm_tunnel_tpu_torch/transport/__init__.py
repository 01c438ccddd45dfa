"""Transports: the byte-message channel the tunnel endpoints run over.

The contract (`Channel`) mirrors the reference's DataChannelPair semantics
(reference tunnel/src/rtc.rs:23-28): a send handle, an ordered stream of
received raw frames, and connected/disconnected events.  Implementations:

- ``loopback_pair()`` — in-process pair for tests and same-process stacks.
- ``TcpChannel`` — encrypted message framing over one TCP connection.
- ``UdpChannel`` — hole-punched encrypted reliable UDP (the P2P data plane).
- ``connect()`` — full rendezvous: signaling, role election, key exchange,
  candidate punch — returns an established Channel (rtc.rs:463-514 analog).
"""

from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.transport.chaos import ChaosChannel, ChaosSpec, maybe_chaos
from p2p_llm_tunnel_tpu_torch.transport.connect import ConnectError, connect
from p2p_llm_tunnel_tpu_torch.transport.loopback import loopback_pair
from p2p_llm_tunnel_tpu_torch.transport.tcp import TcpChannel
from p2p_llm_tunnel_tpu_torch.transport.udp import UdpChannel

__all__ = [
    "Channel",
    "ChannelClosed",
    "ChaosChannel",
    "ChaosSpec",
    "maybe_chaos",
    "loopback_pair",
    "TcpChannel",
    "UdpChannel",
    "connect",
    "ConnectError",
]
