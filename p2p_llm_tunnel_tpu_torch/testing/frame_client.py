"""Minimal raw-frame tunnel client for robustness tests.

Speaks the wire protocol directly over any :class:`Channel` — no local HTTP
listener — so tests can assert on the exact frames a serve peer emits
(typed ERROR codes, 429 headers, RES_END ordering) instead of the proxy's
HTTP rendering of them.  Used by tests/test_chaos.py and
tests/test_deadlines.py.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    Agree,
    Hello,
    MessageType,
    ProtocolError,
    RequestHeaders,
    ResponseHeaders,
    TunnelMessage,
)
from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class StreamResult:
    """Everything the serve peer sent for one stream id."""

    status: Optional[int] = None
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytearray = field(default_factory=bytearray)
    error: Optional[str] = None  # ERROR frame payload text
    error_code: Optional[str] = None  # typed [code], None for plain text
    ended: asyncio.Event = field(default_factory=asyncio.Event)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


class FrameClient:
    """Drives the proxy side of the handshake + N raw request streams."""

    def __init__(self, channel: Channel, *, pad_pings: bool = False,
                 reply_pings: bool = True):
        self.channel = channel
        self.streams: Dict[int, StreamResult] = {}
        self.agree: Optional[Agree] = None
        self._next_sid = 1
        self._reader: Optional[asyncio.Task] = None
        # pad_pings: follow EVERY outgoing frame with a harmless PING, so a
        # seeded chaos schedule has loss-tolerant targets at every other
        # index.  reply_pings=False keeps the outgoing message sequence a
        # pure function of the scripted requests (a timing-dependent PONG
        # would shift the chaos schedule between runs).
        self.pad_pings = pad_pings
        self.reply_pings = reply_pings

    async def _send(self, frame: bytes) -> None:
        await self.channel.send(frame)
        if self.pad_pings:
            await self.channel.send(TunnelMessage.ping().encode())

    async def handshake(self, timeout: float = 30.0) -> Agree:
        await self._send(TunnelMessage.hello(Hello()).encode())
        raw = await asyncio.wait_for(self.channel.recv(), timeout)
        msg = TunnelMessage.decode(raw)
        assert msg.msg_type == MessageType.AGREE, msg.msg_type
        self.agree = Agree.from_json(msg.payload)
        self._reader = asyncio.create_task(self._read_loop())
        return self.agree

    async def _read_loop(self) -> None:
        while True:
            try:
                raw = await self.channel.recv()
            except ChannelClosed:
                for s in self.streams.values():
                    s.ended.set()
                return
            try:
                msg = TunnelMessage.decode(raw)
            except ProtocolError:
                continue
            s = self.streams.get(msg.stream_id)
            if msg.msg_type == MessageType.PING:
                if not self.reply_pings:
                    continue
                try:
                    await self.channel.send(TunnelMessage.pong().encode())
                except ChannelClosed:
                    return
            elif s is None:
                continue
            elif msg.msg_type == MessageType.RES_HEADERS:
                h = ResponseHeaders.from_json(msg.payload)
                s.status = h.status
                s.headers = {k.lower(): v for k, v in h.headers.items()}
            elif msg.msg_type == MessageType.RES_BODY:
                s.body.extend(msg.payload)
            elif msg.msg_type == MessageType.ERROR:
                s.error = msg.payload.decode("utf-8", "replace")
                s.error_code = msg.error_code()
            elif msg.msg_type == MessageType.RES_END:
                s.ended.set()
            else:
                # Request-direction and handshake frames are never addressed
                # to a client; dropping them silently here is deliberate.
                log.debug("frame client ignoring %s", msg.msg_type.name)

    async def request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> StreamResult:
        """Send one whole request; returns its (live) StreamResult."""
        sid = self._next_sid
        self._next_sid += 1
        result = StreamResult()
        self.streams[sid] = result
        payload = json.dumps(body).encode() if body is not None else b""
        hdrs = dict(headers or {})
        await self._send(
            TunnelMessage.req_headers(
                RequestHeaders(sid, method, path, hdrs)
            ).encode()
        )
        if payload or self.pad_pings:
            # Under pad_pings the body frame ALWAYS goes out (empty is
            # legal) so the send sequence has a fixed shape per request.
            await self._send(TunnelMessage.req_body(sid, payload).encode())
        await self._send(TunnelMessage.req_end(sid).encode())
        return result

    async def wait(self, result: StreamResult, timeout: float = 60.0) -> StreamResult:
        await asyncio.wait_for(result.ended.wait(), timeout)
        return result

    def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()


async def sse_events(result: StreamResult) -> List[dict]:
    """Parse an OpenAI SSE body into its JSON chunks (skips [DONE])."""
    out: List[dict] = []
    for line in result.text.split("\n\n"):
        line = line.strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            continue
        out.append(json.loads(data))
    return out
