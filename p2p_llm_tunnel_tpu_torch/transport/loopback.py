"""In-process loopback channel pair.

The testing substrate SURVEY.md §7 step 1 calls for: two cross-wired Channels
standing in for the P2P data channel, so the protocol and endpoint layers are
testable without any networking.  Closing either side closes both (a real
data channel dies as a unit).
"""

from __future__ import annotations

from typing import Optional, Tuple

from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed


class LoopbackChannel(Channel):
    def __init__(self) -> None:
        super().__init__()
        self._peer: Optional["LoopbackChannel"] = None
        #: Test hook: artificial per-message latency injector (async callable).
        self.before_deliver = None

    async def _send_impl(self, data: bytes) -> None:
        peer = self._peer
        if peer is None or peer.is_closed:
            raise ChannelClosed("peer closed")
        if self.before_deliver is not None:
            await self.before_deliver(data)
        peer._deliver(bytes(data))

    def _close_impl(self) -> None:
        peer = self._peer
        if peer is not None and not peer.is_closed:
            peer.close()


def loopback_pair() -> Tuple[LoopbackChannel, LoopbackChannel]:
    """A connected pair of in-process channels."""
    a, b = LoopbackChannel(), LoopbackChannel()
    a._peer, b._peer = b, a
    a.connected.set()
    b.connected.set()
    return a, b
