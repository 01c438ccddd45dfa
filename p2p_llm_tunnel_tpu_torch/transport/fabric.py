"""Proxy-side fabric dialer: one proxy, N serve peers.

The legacy ``transport.connect`` dance assumes a 2-peer room and a shared
arrival-order role election.  A fabric room instead has exactly one
``proxy`` peer — always the OFFERER — and up to N ``serve`` peers — always
answerers (they use ``connect(role="serve")``).  This module is the proxy
half: it joins role-tagged, watches the room, and for every serve peer
present or arriving runs the standard ``_establish`` dance over a
*scoped* view of the one signaling socket (sends target that peer via
``to=``; receives are demuxed by ``from``), then admits the established
channel into the proxy's :class:`~p2p_llm_tunnel_tpu_torch.endpoints.peerset.PeerSet`.

Supervision split: each serve peer's own ``run_with_retry`` loop re-dials
the room when its channel dies, producing a fresh ``peer-joined`` here —
so the per-peer reconnect lifecycle lives with the peer that died, while
this dialer only pays a BOUNDED per-peer establishment retry (a peer whose
dials keep failing must rejoin; the signaling socket's death ends the
whole fabric and the caller's supervisor re-runs it).
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Dict, Optional

from p2p_llm_tunnel_tpu_torch.protocol.frames import TunnelMessage
from p2p_llm_tunnel_tpu_torch.signaling.client import (
    Answer,
    Candidate,
    Joined,
    Offer,
    PeerJoined,
    PeerLeft,
    SignalError,
    SignalingClient,
)
from p2p_llm_tunnel_tpu_torch.transport.chaos import maybe_chaos
from p2p_llm_tunnel_tpu_torch.transport.connect import (
    CONNECT_TIMEOUT,
    _establish,
    _expect,
)
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Bounded per-peer establishment retries: beyond this the peer must
#: rejoin the room (its own supervisor owns the infinite loop).
DIAL_ATTEMPTS = 3
DIAL_BACKOFF_S = 1.0
DIAL_BACKOFF_MAX_S = 10.0


class _ScopedSignaling:
    """Per-peer view of the shared signaling socket.

    ``_establish``/``_accept_trickle`` were written against the
    SignalingClient surface; this adapter keeps them verbatim in the
    N-peer world — sends carry ``to=<peer>``, ``recv()`` yields only that
    peer's messages (the dialer's demux loop feeds them in).
    """

    def __init__(self, client: SignalingClient, peer_id: str):
        self._client = client
        self.peer_id = peer_id
        #: _establish pins this on the answer path; our sends already
        #: target the peer, so it is bookkeeping only.
        self.reply_to = peer_id
        self._q: "asyncio.Queue" = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded by one peer's handshake signaling (one offer/answer plus a handful of trickled candidates); torn down with the dial attempt

    def deliver(self, msg) -> None:
        self._q.put_nowait(msg)

    async def recv(self, timeout: Optional[float] = None):
        if timeout is None:
            return await self._q.get()
        return await asyncio.wait_for(self._q.get(), timeout)

    async def send_offer(self, sdp, to: Optional[str] = None) -> None:
        await self._client.send_offer(sdp, to=self.peer_id)

    async def send_answer(self, sdp, to: Optional[str] = None) -> None:
        await self._client.send_answer(sdp, to=self.peer_id)

    async def send_candidate(self, cand, to: Optional[str] = None) -> None:
        await self._client.send_candidate(cand, to=self.peer_id)


async def run_fabric_dialer(
    signal_url: str,
    room: str,
    transport: str,
    state,
    max_peers: int = 0,
    stun_server: Optional[str] = None,
    relay: Optional[str] = None,
    relay_secret: Optional[str] = None,
    on_admit: Optional[Callable] = None,
) -> None:
    """Join ``room`` as its proxy and keep its PeerSet populated.

    Establishes a channel to every serve peer already present and every
    one that later joins (up to ``max_peers``; 0 = unlimited), admitting
    each into ``state`` (a PeerSet).  Returns when the signaling socket
    dies — after setting ``state.closed`` so ``run_proxy_fabric`` exits
    and the caller's supervisor re-runs the whole fabric.
    """
    signaling = await SignalingClient.connect(signal_url, room, role="proxy")
    dial_tasks: Dict[str, asyncio.Task] = {}
    scopes: Dict[str, _ScopedSignaling] = {}
    try:
        joined = await _expect(signaling, Joined, tolerant=True)
        observed_ip = joined.observed[0] if joined.observed else None
        log.info("fabric: joined room %r as proxy; %d peer(s) present",
                 room, len(joined.peers))

        def want(peer_id: str, role: str) -> bool:
            if role not in ("", "serve"):
                return False
            if peer_id in dial_tasks or peer_id in state.peers:
                return False
            if max_peers and (
                    len(state.peers) + len(dial_tasks)) >= max_peers:
                log.info("fabric: ignoring peer %s (at --peers cap %d)",
                         peer_id[:8], max_peers)
                return False
            return True

        def spawn(peer_id: str) -> None:
            task = asyncio.create_task(_dial_peer(
                signaling, scopes, peer_id, room, observed_ip, transport,
                state, stun_server, relay, relay_secret, on_admit,
            ))
            dial_tasks[peer_id] = task
            task.add_done_callback(lambda _t: dial_tasks.pop(peer_id, None))

        for pid in joined.peers:
            if want(pid, joined.roles.get(pid, "serve")):
                spawn(pid)

        while True:
            msg = await signaling.recv()
            if msg is None:
                log.warning("fabric: signaling socket closed")
                return
            if isinstance(msg, PeerJoined):
                if want(msg.peer_id, msg.role or "serve"):
                    log.info("fabric: serve peer %s joined; dialing",
                             msg.peer_id[:8])
                    spawn(msg.peer_id)
            elif isinstance(msg, (Answer, Candidate, Offer)):
                scope = scopes.get(msg.sender)
                if scope is not None:
                    scope.deliver(msg)
                else:
                    log.debug("fabric: dropping %s from unknown peer %s",
                              type(msg).__name__, msg.sender[:8])
            elif isinstance(msg, PeerLeft):
                task = dial_tasks.get(msg.peer_id)
                if task is not None:
                    task.cancel()
                scope = scopes.get(msg.peer_id)
                if scope is not None:
                    # The scoped _expect raises on PeerLeft (not tolerant):
                    # a mid-dial departure aborts that dial cleanly.
                    scope.deliver(msg)
                state.remove(msg.peer_id, TunnelMessage.typed_error(
                    0, "peer_lost", "peer left the room"))
            elif isinstance(msg, SignalError):
                # E.g. "no such peer in room": a relay raced a departure.
                # Not attributable to one dial without a correlation id —
                # the affected dial times out and retries on its own.
                log.warning("fabric: signaling error: %s", msg.message)
    finally:
        for task in list(dial_tasks.values()):
            task.cancel()
        state.closed.set()
        await signaling.close()


async def _dial_peer(
    signaling: SignalingClient,
    scopes: Dict[str, _ScopedSignaling],
    peer_id: str,
    room: str,
    observed_ip: Optional[str],
    transport: str,
    state,
    stun_server: Optional[str],
    relay: Optional[str],
    relay_secret: Optional[str],
    on_admit: Optional[Callable],
) -> None:
    """Offerer dance + PeerSet admission for ONE serve peer, with bounded
    capped-backoff-plus-jitter retries (tunnelcheck TC11's contract)."""
    for attempt in range(1, DIAL_ATTEMPTS + 1):
        scope = _ScopedSignaling(signaling, peer_id)
        scopes[peer_id] = scope
        try:
            channel = await asyncio.wait_for(
                _establish(scope, room, observed_ip, transport, offerer=True,
                           stun_server=stun_server, relay=relay,
                           relay_secret=relay_secret),
                CONNECT_TIMEOUT,
            )
            link = await state.admit(maybe_chaos(channel), peer_id=peer_id)
            log.info("fabric: serve peer %s admitted (attempt %d)",
                     peer_id[:8], attempt)
            if on_admit is not None:
                on_admit(link)
            return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("fabric: dial to %s failed (attempt %d/%d): %s",
                        peer_id[:8], attempt, DIAL_ATTEMPTS, e)
        finally:
            scopes.pop(peer_id, None)
        if attempt >= DIAL_ATTEMPTS:
            log.warning("fabric: giving up on peer %s; it must rejoin",
                        peer_id[:8])
            return
        backoff = min(DIAL_BACKOFF_S * (2 ** (attempt - 1)),
                      DIAL_BACKOFF_MAX_S)
        backoff *= 1.0 + random.uniform(0.0, 0.5)
        await asyncio.sleep(backoff)
