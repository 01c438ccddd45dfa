"""Encrypted, message-oriented channel over TCP.

Wire format: ``[len:u32 BE][sealed]`` where ``sealed`` is the SecureBox
output for one whole tunnel frame — message boundaries are preserved, so
the layer above sees the same datagram semantics as the reference's WebRTC
data channel (rtc.rs:23-28 DataChannelPair contract, via transport.base).

This is the "direct" transport: used when one peer can reach the other's
TCP address (LAN, same host, or a reachable server).  The hole-punched UDP
transport (transport/udp.py) covers the NAT-traversal case.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.transport.crypto import CryptoError, SecureBox
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAX_WIRE_FRAME = 1 << 20  # sanity cap, well above 64 KiB tunnel frames


class TcpChannel(Channel):
    """Channel over one established TCP connection (optionally encrypted)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        box: Optional[SecureBox] = None,
    ) -> None:
        super().__init__()
        self._reader = reader
        self._writer = writer
        self._box = box
        self._write_lock = asyncio.Lock()
        self._reader_task = asyncio.create_task(self._read_loop())
        self.connected.set()

    async def _send_impl(self, data: bytes) -> None:
        payload = self._box.seal(data) if self._box is not None else data
        if len(payload) > MAX_WIRE_FRAME:
            raise ValueError(f"frame too large: {len(payload)}")
        async with self._write_lock:
            try:
                self._writer.write(struct.pack(">I", len(payload)) + payload)
                await self._writer.drain()
            except (ConnectionError, OSError) as e:
                log.debug("tcp send failed: %s", e)
                self.close()
                raise ChannelClosed("tcp connection lost") from e

    async def _read_loop(self) -> None:
        try:
            while True:
                header = await self._reader.readexactly(4)
                (length,) = struct.unpack(">I", header)
                if length > MAX_WIRE_FRAME:
                    log.warning("oversized wire frame (%d); closing", length)
                    return
                payload = await self._reader.readexactly(length)
                if self._box is not None:
                    try:
                        payload = self._box.open(payload)
                    except CryptoError as e:
                        log.warning("tcp frame failed authentication: %s", e)
                        return
                self._deliver(payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.close()

    def _close_impl(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
        if self._reader_task is not asyncio.current_task():
            self._reader_task.cancel()
