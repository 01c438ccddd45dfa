"""P2P connection establishment: signaling dance → established Channel.

The rtc.rs:463-514 equivalent, with the same observable semantics:
- role election: the first peer in the room waits for ``peer-joined`` and
  becomes the OFFERER; a peer that finds the room occupied answers
  (rtc.rs:471-505)
- the offer/answer carry this stack's "SDP": the transport kind, an
  ephemeral X25519 public key, and gathered candidates
- candidates arriving before the remote description are handled naturally
  (our candidates ride inside the offer/answer, so the reference's
  buffering subtlety at rtc.rs:194-223 collapses; late trickled candidates
  are also accepted while punching)
- failure exits — peer-left, signaling error, socket loss, punch timeout —
  raise, feeding the supervisor retry loop (rtc.rs:224-232)
"""

from __future__ import annotations

import asyncio
import os
import socket
from typing import List, Optional, Tuple

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
from p2p_llm_tunnel_tpu_torch.transport.base import Channel
from p2p_llm_tunnel_tpu_torch.transport.crypto import HandshakeKeys
from p2p_llm_tunnel_tpu_torch.transport.tcp import TcpChannel
from p2p_llm_tunnel_tpu_torch.transport.udp import UdpChannel
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CONNECT_TIMEOUT = 30.0
PUNCH_TIMEOUT = 10.0


class ConnectError(Exception):
    """Connection establishment failed; the supervisor should retry."""


def _local_addresses() -> List[str]:
    """Candidate local IPs: loopback, hostname lookups, default-route trick."""
    addrs = {"127.0.0.1"}
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET):
            addrs.add(info[4][0])
    except socket.gaierror:
        pass
    # UDP-connect trick: the OS picks the default-route source address.
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            addrs.add(s.getsockname()[0])
        finally:
            s.close()
    except OSError:
        pass
    return sorted(addrs)


async def connect(
    signal_url: str,
    room: str,
    transport: str = "udp",
    timeout: float = CONNECT_TIMEOUT,
    stun_server: Optional[str] = None,
    relay: Optional[str] = None,
    relay_secret: Optional[str] = None,
    role: Optional[str] = None,
) -> Tuple[Channel, SignalingClient]:
    """Rendezvous in ``room`` and return an established data channel.

    ``stun_server`` ('host[:port]') adds a server-reflexive candidate
    learned from the punching socket itself (rtc.rs:49-52 equivalent);
    ``relay`` ('host[:port]') names the encrypted-blind relay both peers
    fall back to when direct punching times out (rtc.rs:55-63 equivalent).

    ``role`` opts into the fabric's role-tagged rooms:
    ``"serve"`` joins as one of N provider peers and ALWAYS answers (the
    proxy is the fabric's sole offerer), ignoring other serve peers'
    comings and goings.  ``None`` keeps the legacy arrival-order election
    in 2-peer rooms.  (The proxy side of a fabric room dials through
    ``transport.fabric``, not here.)

    The caller owns both returned objects; close the signaling client once
    the channel is up if trickle candidates are no longer needed.
    """
    try:
        return await asyncio.wait_for(
            _connect_inner(signal_url, room, transport, stun_server, relay,
                           relay_secret, role),
            timeout,
        )
    except asyncio.TimeoutError:
        raise ConnectError(f"connect timed out after {timeout}s")


async def _connect_inner(
    signal_url: str, room: str, transport: str,
    stun_server: Optional[str], relay: Optional[str],
    relay_secret: Optional[str] = None,
    role: Optional[str] = None,
) -> Tuple[Channel, SignalingClient]:
    # Validate any TUNNEL_CHAOS spec BEFORE any resource exists: a typo'd
    # spec must fail fast, not leak an established channel per retry.
    from p2p_llm_tunnel_tpu_torch.transport.chaos import ChaosSpec, ENV_VAR

    ChaosSpec.parse(os.environ.get(ENV_VAR, ""))

    signaling = await SignalingClient.connect(signal_url, room,
                                              role=role or "")
    try:
        joined = await _expect(signaling, Joined)
        observed_ip: Optional[str] = (
            joined.observed[0] if joined.observed else None
        )
        if role == "serve":
            # Fabric serve peer: wait for the proxy's targeted offer; a
            # DIFFERENT serve peer leaving must not abort this dance, so
            # establishment runs tolerant of unrelated peer-left events
            # (the outer connect() timeout still bounds the wait).
            log.info("room %r joined as serve peer; awaiting proxy offer",
                     room)
            channel = await _establish(signaling, room, observed_ip,
                                       transport, offerer=False,
                                       stun_server=stun_server, relay=relay,
                                       relay_secret=relay_secret,
                                       tolerant=True)
        elif not joined.peers:
            log.info("room %r empty; waiting for a peer (offerer role)", room)
            await _expect(signaling, PeerJoined)
            channel = await _establish(signaling, room, observed_ip, transport,
                                       offerer=True, stun_server=stun_server,
                                       relay=relay, relay_secret=relay_secret)
        else:
            log.info("room %r occupied; answering", room)
            channel = await _establish(signaling, room, observed_ip, transport,
                                       offerer=False, stun_server=stun_server,
                                       relay=relay, relay_secret=relay_secret)
        # Opt-in fault injection (TUNNEL_CHAOS): wraps the established
        # channel so every endpoint above sees the injected faults.
        from p2p_llm_tunnel_tpu_torch.transport.chaos import maybe_chaos

        return maybe_chaos(channel), signaling
    except BaseException:
        await signaling.close()
        raise


async def _expect(signaling: SignalingClient, kind, tolerant: bool = False):
    """Wait for one message of ``kind``; error/peer-left/EOF raise.

    ``tolerant`` ignores peer-left events instead of raising — fabric
    rooms see unrelated serve peers leave mid-establishment; the caller's
    timeout bounds the wait when the RELEVANT peer is the one that left.
    """
    while True:
        msg = await signaling.recv()
        if msg is None:
            raise ConnectError("signaling socket closed")
        if isinstance(msg, kind):
            return msg
        if isinstance(msg, SignalError):
            raise ConnectError(f"signaling error: {msg.message}")
        if isinstance(msg, PeerLeft) and not tolerant:
            raise ConnectError("peer left during establishment")
        log.debug("ignoring %s while waiting for %s", type(msg).__name__, kind.__name__)


def _udp_candidates(
    port: int,
    observed_ip: Optional[str],
    reflexive: Optional[Tuple[str, int]] = None,
) -> List[List]:
    cands = [[ip, port] for ip in _local_addresses()]
    if reflexive is not None and list(reflexive) not in cands:
        # Server-reflexive candidate from a real STUN query off the punching
        # socket — the exact NAT mapping the peer must hit (rtc.rs:49-52).
        cands.append([reflexive[0], reflexive[1]])
    if observed_ip and all(ip != observed_ip for ip, _ in cands):
        # NAT-external guess: same port as bound (works for cone NATs that
        # preserve ports); the relay fallback covers the NATs this misses.
        cands.append([observed_ip, port])
    return cands


async def _establish(
    signaling: SignalingClient,
    room: str,
    observed_ip: Optional[str],
    transport: str,
    offerer: bool,
    stun_server: Optional[str] = None,
    relay: Optional[str] = None,
    relay_secret: Optional[str] = None,
    tolerant: bool = False,
) -> Channel:
    keys = HandshakeKeys()
    channel: Optional[UdpChannel] = None
    server: Optional[asyncio.AbstractServer] = None
    accepted: "Optional[asyncio.Future]" = None
    stun_task: Optional[asyncio.Task] = None
    handed_off = False  # set once a channel is returned to the caller

    # Any exit before the channel is handed to the caller — signaling
    # failure, mismatch, punch timeout, or cancellation from the outer
    # connect() deadline — must release the bound socket/listener, or the
    # supervisor's infinite retries leak one fd per attempt.
    try:
        if transport == "udp":
            channel = await UdpChannel.bind()
            reflexive = None
            if stun_server:
                from p2p_llm_tunnel_tpu_torch.transport.stun import parse_server

                # Gather concurrently: a fast STUN answer rides inside the
                # offer/answer; a slow one is TRICKLED via send_candidate
                # while punching is already underway — the reference
                # trickles ICE the same way (rtc.rs:194-223) instead of
                # blocking the whole dance on gathering.
                stun_task = asyncio.create_task(
                    channel.stun_query([parse_server(stun_server)], timeout=5.0)
                )
                done, _ = await asyncio.wait({stun_task}, timeout=0.5)
                if done:
                    reflexive = stun_task.result()
                    stun_task = None
                    if reflexive:
                        log.info("stun reflexive candidate: %s:%d", *reflexive)
            sdp = {
                "kind": "udp",
                "pubkey": keys.public_bytes.hex(),
                "candidates": _udp_candidates(
                    channel.local_port, observed_ip, reflexive
                ),
            }
            if relay:
                from p2p_llm_tunnel_tpu_torch.transport.relay import parse_relay

                rh, rp = parse_relay(relay)
                # The offerer's token wins (both peers must present the same
                # one); answerer proposes only if the offer had no relay.
                import os as _os

                sdp["relay"] = [rh, rp, _os.urandom(12).hex()]
        elif transport == "tcp":
            if offerer:
                accepted = asyncio.get_running_loop().create_future()

                def on_conn(r, w, fut=accepted):
                    if not fut.done():
                        fut.set_result((r, w))
                    else:
                        w.close()

                server = await asyncio.start_server(on_conn, "0.0.0.0", 0)
                port = server.sockets[0].getsockname()[1]
                sdp = {
                    "kind": "tcp",
                    "pubkey": keys.public_bytes.hex(),
                    "candidates": _udp_candidates(port, observed_ip),
                }
            else:
                sdp = {"kind": "tcp", "pubkey": keys.public_bytes.hex(),
                       "candidates": []}
        else:
            raise ConnectError(f"unknown transport {transport!r}")

        # -- SDP exchange --------------------------------------------------
        if offerer:
            await signaling.send_offer(sdp)
            answer = await _expect(signaling, Answer, tolerant)
            remote = answer.sdp
        else:
            offer = await _expect(signaling, Offer, tolerant)
            remote = offer.sdp
            if offer.sender and getattr(signaling, "reply_to", None) is not None:
                # N-peer rooms: the answer (and any trickled candidates)
                # must target the offerer — an untargeted relay is
                # ambiguous once the room holds more than two peers.
                signaling.reply_to = offer.sender
            await signaling.send_answer(sdp)

        if remote.get("kind") != transport:
            raise ConnectError(
                f"transport mismatch: we={transport} peer={remote.get('kind')}"
            )
        try:
            peer_pub = bytes.fromhex(remote["pubkey"])
        except (KeyError, ValueError):
            raise ConnectError("peer offer/answer missing a valid pubkey")
        box = keys.derive(peer_pub, offerer=offerer, room=room)
        remote_cands = [tuple(c) for c in remote.get("candidates", [])]

        # -- transport establishment --------------------------------------
        if transport == "udp":
            channel.set_session(box)
            punch_list = [(str(h), int(p)) for h, p in remote_cands]
            # Relay rendezvous: the OFFER's relay+token wins on BOTH sides
            # (each peer must join the same relay with the same token); the
            # answer's is the fallback when the offer proposed none.
            if offerer:
                relay_info = sdp.get("relay") or remote.get("relay")
            else:
                relay_info = remote.get("relay") or sdp.get("relay")
            trickle = asyncio.create_task(_accept_trickle(signaling, punch_list))
            late_trickle: Optional[asyncio.Task] = None
            if stun_task is not None:
                late_trickle = asyncio.create_task(
                    _send_late_reflexive(signaling, stun_task, sdp["candidates"])
                )
            try:
                await channel.punch(punch_list, PUNCH_TIMEOUT)
            except TimeoutError as e:
                if not relay_info:
                    raise ConnectError(str(e))
                # Direct punching failed (symmetric/port-rewriting NATs):
                # pivot through the encrypted-blind relay (rtc.rs:55-63
                # TURN-equivalent).  The channel's datagrams stay sealed
                # end-to-end; the relay only forwards ciphertext.
                rh, rp, token = str(relay_info[0]), int(relay_info[1]), str(relay_info[2])
                log.warning("hole punch failed; falling back to relay %s:%d", rh, rp)
                try:
                    await channel.join_relay((rh, rp), token,
                                             secret=relay_secret)
                    await channel.punch([(rh, rp)], PUNCH_TIMEOUT)
                except (TimeoutError, PermissionError) as e2:
                    raise ConnectError(f"relay fallback failed: {e2}")
            finally:
                trickle.cancel()
                if late_trickle is not None:
                    late_trickle.cancel()
            out, channel = channel, None  # ownership passes to the caller
            return out

        if offerer:
            try:
                reader, writer = await asyncio.wait_for(accepted, PUNCH_TIMEOUT)
            except asyncio.TimeoutError:
                raise ConnectError("tcp peer never dialed")
            handed_off = True
            return TcpChannel(reader, writer, box)
        last_err: Optional[Exception] = None
        for host, port in remote_cands:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(str(host), int(port)), 3.0
                )
                handed_off = True
                return TcpChannel(reader, writer, box)
            except (OSError, asyncio.TimeoutError) as e:
                last_err = e
        raise ConnectError(f"could not reach any tcp candidate: {last_err}")
    finally:
        if stun_task is not None and not stun_task.done():
            # Error/timeout exits must not leave a 5 s STUN query running
            # against a channel this block is about to close (the
            # late-trickle wrapper's cancel does not cancel the inner task).
            stun_task.cancel()
        if channel is not None:
            channel.close()
        if server is not None:
            # close() stops the listener; do NOT wait_closed() — on 3.12 it
            # blocks until accepted connections (the live tunnel!) close.
            server.close()
        if (not handed_off and accepted is not None and accepted.done()
                and not accepted.cancelled() and accepted.exception() is None):
            # The peer dialed but establishment failed afterwards — release
            # the accepted socket or infinite retries leak one fd each.
            _, w = accepted.result()
            w.close()


async def _send_late_reflexive(
    signaling: SignalingClient,
    stun_task: "asyncio.Task",
    advertised: List[List],
) -> None:
    """Trickle a late-arriving STUN reflexive address to the peer.

    The half the reference has that an earlier version lacked: we
    RECEIVED trickled candidates but never SENT one — a reflexive address
    discovered after the offer/answer went out could never reach the peer,
    so punching could only succeed through addresses known up front."""
    try:
        reflexive = await stun_task
    except asyncio.CancelledError:
        raise
    except Exception as e:  # STUN failure just means nothing to trickle
        log.debug("late stun query failed: %s", e)
        return
    if reflexive is None:
        return
    ip, port = reflexive
    if [ip, port] in advertised or (ip, port) in advertised:
        return
    log.info("trickling late reflexive candidate %s:%d", ip, port)
    await signaling.send_candidate({"ip": ip, "port": port})


async def _accept_trickle(
    signaling: SignalingClient, cands: List[Tuple]
) -> None:
    """Collect late candidates while punching (reference trickles ICE)."""
    while True:
        msg = await signaling.recv()
        if msg is None:
            return
        if isinstance(msg, Candidate):
            expected = getattr(signaling, "reply_to", "")
            if expected and msg.sender and msg.sender != expected:
                # Fabric rooms: another peer's trickle is not ours to punch.
                continue
            c = msg.candidate
            if c.get("ip") is None or c.get("port") is None:
                continue
            pair = (str(c["ip"]), int(c["port"]))
            if pair not in cands:
                cands.append(pair)
