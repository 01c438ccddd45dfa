"""The rendezvous server: WebSocket rooms relaying handshake JSON.

Behavioral contract from the reference signal server
(signal-server/src/index.ts):
- ``join {room}`` → assigns a UUID peer id, replies ``joined {peerId, peers}``
  with the ids already present, and notifies the existing peer with
  ``peer-joined {peerId}`` (index.ts:112-154)
- untagged rooms hold at most TWO peers; a third join gets ``error "room is
  full"`` (index.ts:35, :126-129)
- ``offer`` / ``answer`` / ``candidate`` are relayed VERBATIM to the other
  peer in the room, with ``from`` set (index.ts:156-193)
- ``bye``, socket close, or socket error → remove the peer and send
  ``peer-left`` to the survivors (index.ts:56-78, :195-220)
- the server never carries tunnel traffic — handshake metadata only

Beyond the reference: a join may carry a ``role`` —
``"proxy"`` or ``"serve"`` — lifting the 2-peer cap into PER-ROLE caps:
one proxy, up to ``max_serve_peers`` serve peers.  Role-tagged relays
target a specific peer via ``to`` (required once a room can hold more than
two occupants); ``joined`` answers include a ``roles`` map and
``peer-joined``/``peer-left`` fan out to EVERY other occupant with the
joiner's role.  Untagged joins keep the exact legacy contract, and the
extension fields ride unknown-key-tolerant JSON, so reference peers
interoperate unchanged in 2-peer rooms.

Run standalone: ``python -m p2p_llm_tunnel_tpu_torch.signaling.server --port 8787``.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

try:
    import websockets
    from websockets.asyncio.server import ServerConnection, serve
except ImportError:  # gated optional dep (see signaling/client.py): the
    # rendezvous server cannot RUN without websockets, but importing this
    # module must not fail — loopback stacks and tests never start it.
    websockets = None
    ServerConnection = None
    serve = None

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAX_ROOM_SIZE = 2  # index.ts:35 (untagged legacy rooms)
#: Per-role cap for role-tagged rooms: at most one proxy fans requests
#: across up to this many serve peers.
MAX_SERVE_PEERS = 32

RELAYED_TYPES = {"offer", "answer", "candidate"}
ROLES = {"proxy", "serve"}


@dataclass
class _Peer:
    peer_id: str
    room: str
    ws: ServerConnection
    role: str = ""  # "" = legacy untagged join


@dataclass
class SignalServer:
    """In-process signal server; also usable as the standalone entry point."""

    host: str = "127.0.0.1"
    port: int = 8787
    max_serve_peers: int = MAX_SERVE_PEERS
    rooms: Dict[str, Set[str]] = field(default_factory=dict)
    peers: Dict[str, _Peer] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._server = None

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> int:
        """Bind and serve; returns the bound port (for port 0)."""
        if serve is None:
            raise RuntimeError(
                "the 'websockets' package is required to run the signal "
                "server (pip install websockets)"
            )
        self._server = await serve(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # tunnelcheck: disable=TC13  start() runs once on the owning entrypoint before any concurrent use; the port-0 -> bound-port rewrite is that single call's handoff, not a shared RMW
        log.info("signal server listening on ws://%s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        # Claim-then-await (tunnelcheck TC13): the handle is cleared
        # BEFORE the suspension, so a concurrent stop() — entrypoint
        # teardown racing a test's finally — finds None instead of
        # close()/wait_closed()-ing a server the first caller is mid-way
        # through tearing down.
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        await asyncio.Future()

    # -- helpers ----------------------------------------------------------

    def _occupants(self, room: str) -> List[_Peer]:
        return [
            p for p in (self.peers.get(pid) for pid in self.rooms.get(room, ()))
            if p is not None
        ]

    def _others(self, peer: _Peer) -> List[_Peer]:
        """Every other occupant of the peer's room (index.ts:45-54,
        generalized past two)."""
        return [p for p in self._occupants(peer.room) if p.peer_id != peer.peer_id]

    def _join_refusal(self, room: str, role: str) -> Optional[str]:
        """Why a join must be refused, or None.  Untagged joins keep the
        legacy total-2 cap; tagged joins get per-role caps.  Tagged and
        untagged peers never mix: a fabric peer slipping into a legacy
        2-peer room (typo'd room name) would overfill it and break the
        legacy pair's UNtargeted relay with 'ambiguous relay target' —
        the old server would simply have said 'room is full'."""
        occ = self._occupants(room)
        if not role:
            if any(p.role for p in occ):
                return "room is full: fabric room (role-tagged peers)"
            return "room is full" if len(occ) >= MAX_ROOM_SIZE else None
        if role not in ROLES:
            return f"unknown role {role!r}"
        if any(not p.role for p in occ):
            return "room is full: legacy 2-peer room (untagged peers)"
        if role == "proxy":
            if any(p.role == "proxy" for p in occ):
                return "room is full: a proxy peer is already present"
            return None
        if sum(1 for p in occ if p.role == "serve") >= self.max_serve_peers:
            return f"room is full: {self.max_serve_peers} serve peers"
        return None

    async def _send(self, peer: _Peer, obj: dict) -> None:
        try:
            await peer.ws.send(json.dumps(obj))
        except websockets.ConnectionClosed:
            pass

    async def _remove_peer(self, peer: _Peer) -> None:
        """Drop a peer and tell the survivors (index.ts:56-78)."""
        if self.peers.pop(peer.peer_id, None) is None:
            return
        room = self.rooms.get(peer.room)
        if room is not None:
            room.discard(peer.peer_id)
            if not room:
                del self.rooms[peer.room]
        for other in self._occupants(peer.room):
            await self._send(other, {
                "type": "peer-left", "peerId": peer.peer_id,
                "role": peer.role,
            })
        log.info("[signal] peer %s left room %r", peer.peer_id[:8], peer.room)

    # -- connection handler ------------------------------------------------

    async def _handle(self, ws: ServerConnection) -> None:
        peer: Optional[_Peer] = None
        try:
            async for raw in ws:
                try:
                    msg = json.loads(raw)
                except (json.JSONDecodeError, TypeError):
                    await ws.send(json.dumps({"type": "error", "message": "invalid JSON"}))
                    continue
                mtype = msg.get("type")

                if mtype == "join":
                    if peer is not None:
                        await ws.send(json.dumps(
                            {"type": "error", "message": "already joined"}))
                        continue
                    room_name = msg.get("room")
                    if not isinstance(room_name, str) or not room_name:
                        await ws.send(json.dumps(
                            {"type": "error", "message": "room required"}))
                        continue
                    role = msg.get("role") or ""
                    refusal = self._join_refusal(room_name, role)
                    if refusal is not None:
                        # index.ts:126-129 (per-role caps for tagged joins)
                        await ws.send(json.dumps(
                            {"type": "error", "message": refusal}))
                        continue
                    peer = _Peer(str(uuid.uuid4()), room_name, ws, role)
                    existing = self._occupants(room_name)
                    self.rooms.setdefault(room_name, set()).add(peer.peer_id)
                    self.peers[peer.peer_id] = peer  # tunnelcheck: disable=TC13  single-owner key: this connection's handler task is the only writer of its own fresh uuid key; other handlers' reads are lookups of THEIR keys, not guards for this write
                    # ``observed`` is this server's view of the peer's address
                    # — a built-in STUN-lite so peers can advertise their
                    # NAT-external IP as a candidate (extension field; the
                    # reference schema ignores unknown keys).  ``roles``
                    # likewise: who already holds which fabric role.
                    remote = ws.remote_address
                    await self._send(peer, {
                        "type": "joined", "peerId": peer.peer_id,
                        "peers": [p.peer_id for p in existing],
                        "roles": {p.peer_id: p.role for p in existing},
                        "observed": list(remote[:2]) if remote else None,
                    })
                    for other in existing:
                        await self._send(other, {
                            "type": "peer-joined", "peerId": peer.peer_id,
                            "role": peer.role,
                        })
                    log.info(
                        "[signal] peer %s%s joined room %r (%d occupant(s))",
                        peer.peer_id[:8],
                        f" [{role}]" if role else "",
                        room_name, len(self.rooms[room_name]),
                    )

                elif mtype in RELAYED_TYPES:
                    if peer is None:
                        await ws.send(json.dumps(
                            {"type": "error", "message": "join a room first"}))
                        continue
                    to = msg.get("to")
                    if to is not None:
                        # Targeted relay (fabric rooms): the recipient must
                        # share the room — the proxy addresses one serve
                        # peer per offer, answers go back to the offerer.
                        target = self.peers.get(to)
                        if target is None or target.room != peer.room:
                            await self._send(peer, {
                                "type": "error",
                                "message": f"no such peer in room: {to}"})
                            continue
                    else:
                        others = self._others(peer)
                        if not others:
                            await self._send(peer, {
                                "type": "error", "message": "no peer in room"})
                            continue
                        if len(others) > 1:
                            await self._send(peer, {
                                "type": "error",
                                "message": "ambiguous relay target: "
                                           "specify to=<peerId>"})
                            continue
                        target = others[0]
                    relay = dict(msg)
                    relay["from"] = peer.peer_id
                    relay.pop("to", None)
                    await self._send(target, relay)

                elif mtype == "bye":
                    if peer is not None:
                        await self._remove_peer(peer)
                        peer = None

                else:
                    await ws.send(json.dumps(
                        {"type": "error", "message": f"unknown type {mtype!r}"}))
        except websockets.ConnectionClosed:
            pass
        finally:
            if peer is not None:
                await self._remove_peer(peer)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="tunnel signal server")
    ap.add_argument("--listen", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--max-serve-peers", type=int, default=MAX_SERVE_PEERS,
                    help="serve peers allowed per role-tagged room")
    args = ap.parse_args(argv)
    from p2p_llm_tunnel_tpu_torch.utils.logging import init_logging

    init_logging()
    try:
        asyncio.run(SignalServer(
            args.listen, args.port, max_serve_peers=args.max_serve_peers,
        ).serve_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
