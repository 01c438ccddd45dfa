"""The channel contract every tunnel endpoint runs over.

Semantics match the reference's DataChannelPair (tunnel/src/rtc.rs:23-28):

- ``send(data)``     — enqueue one whole message (a tunnel frame) for the peer.
- ``recv()``         — await the next whole message; raises ChannelClosed when
                       the channel is dead and drained.
- ``connected``      — asyncio.Event set once the channel is usable.
- ``disconnected``   — asyncio.Event set when the channel fails or closes;
                       endpoints select on this to trigger the retry loop
                       (reference serve.rs:85-89, proxy.rs:182-185).

Message boundaries are preserved (datagram-like), exactly like a WebRTC data
channel.  Concrete transports subclass Channel and implement ``_send_impl``.
"""

from __future__ import annotations

import asyncio
from typing import Optional


class ChannelClosed(Exception):
    """The channel is closed; no further messages will arrive."""


class Channel:
    """Base class: an ordered, message-oriented, bidirectional byte channel."""

    def __init__(self) -> None:
        self.connected = asyncio.Event()
        self.disconnected = asyncio.Event()
        self._rx: asyncio.Queue[Optional[bytes]] = asyncio.Queue()  # tunnelcheck: disable=TC10  recv-side demux: both endpoint loops recv() every iteration, and what a PEER can have in flight is bounded upstream (ARQ cwnd on the datagram plane, FLOW credit per response stream); a maxsize here would have to drop frames on overflow, which the loss-handling layers above would misread as network loss
        self._closed = False

    # -- sending ----------------------------------------------------------

    async def send(self, data: bytes) -> None:
        if self._closed:
            raise ChannelClosed("send on closed channel")
        await self._send_impl(data)

    async def _send_impl(self, data: bytes) -> None:
        raise NotImplementedError

    # -- receiving --------------------------------------------------------

    def _deliver(self, data: bytes) -> None:
        """Called by the transport when a whole message arrives."""
        self._rx.put_nowait(data)

    async def recv(self) -> bytes:
        """Next message, preserving order. Raises ChannelClosed at EOF."""
        if self._closed and self._rx.empty():
            raise ChannelClosed("channel closed")
        item = await self._rx.get()
        if item is None:
            # Re-post the sentinel so every waiter wakes up.
            self._rx.put_nowait(None)
            raise ChannelClosed("channel closed")
        return item

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Mark the channel dead; wakes all receivers and sets disconnected."""
        if self._closed:
            return
        self._closed = True
        self._rx.put_nowait(None)
        self.disconnected.set()
        self._close_impl()

    def _close_impl(self) -> None:  # transports override to tear down IO
        pass

    @property
    def is_closed(self) -> bool:
        return self._closed
