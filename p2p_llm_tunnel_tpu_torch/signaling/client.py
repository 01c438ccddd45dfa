"""Signaling client: typed messages over a WebSocket to the rendezvous server.

Contract from the reference client (tunnel/src/signaling.rs):
- ``connect(url, room)`` opens the socket and sends ``join`` immediately
  (signaling.rs:94-99)
- independent reader/writer tasks bridged by queues (signaling.rs:102-148)
- ``recv()`` yields typed incoming messages; returns None when the socket
  dies (signaling.rs:153-161)
- ``close()`` sends ``bye`` best-effort before closing (Drop impl,
  signaling.rs:72-77)
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

try:
    import websockets
    from websockets.asyncio.client import connect as ws_connect
except ImportError:  # gated optional dep: only live signaling needs it.
    # Everything above this module (transport package, endpoints, engine
    # API) must stay importable without websockets — loopback stacks,
    # tests, and offline tools never open a signaling socket.  connect()
    # raises a clear error if actually used.
    websockets = None
    ws_connect = None

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


# -- typed messages (signaling.rs:9-65 ↔ index.ts:6-26) ---------------------

@dataclass
class Joined:
    peer_id: str
    peers: List[str]
    observed: Optional[List[Any]] = None  # server's view of our [ip, port]
    #: Fabric extension: role of each already-present peer
    #: ({peer_id: "proxy"|"serve"|""}); empty against a reference server.
    roles: Dict[str, str] = field(default_factory=dict)


@dataclass
class PeerJoined:
    peer_id: str
    role: str = ""  # fabric extension; "" against a reference server


@dataclass
class PeerLeft:
    peer_id: str
    role: str = ""


@dataclass
class Offer:
    sdp: Dict[str, Any]
    sender: str = ""


@dataclass
class Answer:
    sdp: Dict[str, Any]
    sender: str = ""


@dataclass
class Candidate:
    candidate: Dict[str, Any]
    sender: str = ""


@dataclass
class SignalError:
    message: str


Incoming = Any  # union of the dataclasses above


def _parse(raw: str) -> Optional[Incoming]:
    try:
        msg = json.loads(raw)
    except json.JSONDecodeError:
        log.warning("signal: dropping unparseable message")
        return None
    t = msg.get("type")
    if t == "joined":
        return Joined(
            msg.get("peerId", ""), list(msg.get("peers", [])),
            msg.get("observed"), dict(msg.get("roles") or {}),
        )
    if t == "peer-joined":
        return PeerJoined(msg.get("peerId", ""), msg.get("role", ""))
    if t == "peer-left":
        return PeerLeft(msg.get("peerId", ""), msg.get("role", ""))
    if t == "offer":
        return Offer(msg.get("sdp", {}), msg.get("from", ""))
    if t == "answer":
        return Answer(msg.get("sdp", {}), msg.get("from", ""))
    if t == "candidate":
        return Candidate(msg.get("candidate", {}), msg.get("from", ""))
    if t == "error":
        return SignalError(msg.get("message", ""))
    log.debug("signal: ignoring message type %r", t)
    return None


@dataclass
class SignalingClient:
    """Connected signaling session; create via ``SignalingClient.connect``."""

    room: str
    _ws: Any
    _rx: "asyncio.Queue[Optional[Incoming]]" = field(default_factory=asyncio.Queue)
    _reader: Optional[asyncio.Task] = None
    _closed: bool = False
    #: Fabric role this session joined with ("" = legacy untagged).
    role: str = ""
    #: Default relay target: when set, outgoing offer/answer/candidate
    #: carry ``to=<peer>`` unless the caller passed one — in an N-peer
    #: room an untargeted relay is ambiguous, so an answerer pins this to
    #: the offer's sender (transport/connect.py).
    reply_to: str = ""

    @classmethod
    async def connect(
        cls, signal_url: str, room: str, timeout: float = 15.0,
        role: str = "",
    ) -> "SignalingClient":
        if ws_connect is None:
            raise RuntimeError(
                "the 'websockets' package is required for live signaling "
                "(pip install websockets)"
            )
        ws = await asyncio.wait_for(ws_connect(signal_url), timeout)
        client = cls(room=room, _ws=ws, role=role)
        # join-on-connect (signaling.rs:94-99); a role tag opts into the
        # fabric's per-role room caps — absent, the legacy
        # 2-peer contract applies and a reference server is none the wiser.
        join = {"type": "join", "room": room}
        if role:
            join["role"] = role
        await ws.send(json.dumps(join))
        client._reader = asyncio.create_task(client._read_loop())
        return client

    async def _read_loop(self) -> None:
        try:
            async for raw in self._ws:
                parsed = _parse(raw)
                if parsed is not None:
                    self._rx.put_nowait(parsed)
        except websockets.ConnectionClosed as e:
            log.debug("signal socket closed: %s", e)
        finally:
            self._rx.put_nowait(None)  # EOF marker (recv → None)

    # -- sending ----------------------------------------------------------

    async def send_offer(self, sdp: Dict[str, Any],
                         to: Optional[str] = None) -> None:
        await self._send({"type": "offer", "sdp": sdp}, to)

    async def send_answer(self, sdp: Dict[str, Any],
                          to: Optional[str] = None) -> None:
        await self._send({"type": "answer", "sdp": sdp}, to)

    async def send_candidate(self, candidate: Dict[str, Any],
                             to: Optional[str] = None) -> None:
        await self._send({"type": "candidate", "candidate": candidate}, to)

    async def _send(self, obj: dict, to: Optional[str] = None) -> None:
        to = to or self.reply_to
        if to:
            obj = {**obj, "to": to}
        try:
            await self._ws.send(json.dumps(obj))
        except websockets.ConnectionClosed:
            raise ConnectionError("signaling socket closed")

    # -- receiving --------------------------------------------------------

    async def recv(self, timeout: Optional[float] = None) -> Optional[Incoming]:
        """Next incoming signal; None when the socket is gone."""
        if timeout is None:
            item = await self._rx.get()
        else:
            item = await asyncio.wait_for(self._rx.get(), timeout)
        if item is None:
            self._rx.put_nowait(None)  # keep EOF visible to other waiters
        return item

    # -- lifecycle --------------------------------------------------------

    async def close(self) -> None:
        """bye-on-drop (signaling.rs:72-77): best-effort bye, then close."""
        if self._closed:
            return
        self._closed = True
        try:
            await self._ws.send(json.dumps({"type": "bye"}))
        except Exception:
            pass
        try:
            await self._ws.close()
        except Exception:
            pass
        if self._reader is not None:
            try:
                await asyncio.wait_for(self._reader, 5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._reader.cancel()
