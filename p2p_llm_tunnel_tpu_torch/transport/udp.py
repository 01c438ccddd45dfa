"""Hole-punched, encrypted, reliable UDP channel — the P2P data plane.

The reference gets NAT traversal + reliability + encryption wholesale from
WebRTC (ICE/DTLS/SCTP via the webrtc crate, rtc.rs).  This module is the
native equivalent built on a bare UDP socket:

- **traversal**: both peers learn candidate (ip, port) pairs via signaling
  (host addresses + the signal-server-observed address) and punch by
  spraying PUNCH probes at every candidate; the first authenticated packet
  locks the peer address (symmetric role after that).
- **encryption**: every datagram is sealed with the session SecureBox
  (X25519 keys exchanged in the offer/answer, transport/crypto.py) — an
  unauthenticated packet is dropped, so stray traffic can't spoof frames.
- **reliability**: ARQ — per-packet u32 sequence numbers, cumulative ACKs,
  RTO retransmission, bounded in-flight window
  (real backpressure, which the reference lacks: SURVEY.md §7 hard-part 3).
  Messages are fragmented to MTU-sized packets and reassembled in order,
  preserving data-channel message boundaries.
- **congestion control**: Jacobson/Karn RTT estimation drives the RTO
  (srtt + 4·rttvar, Karn's rule skips retransmitted samples) and an AIMD
  congestion window paces the sender — slow start to ssthresh, additive
  growth after, multiplicative halving on timeout loss (at most once per
  RTT).  The reference inherits all of this from SCTP inside the webrtc
  crate (rtc.rs via Cargo.toml:14); this is the native equivalent, so
  behavior under WAN loss degrades gracefully instead of retransmit-
  storming at a fixed RTO floor.
- **liveness**: keepalive probes every 5 s; the channel declares itself
  disconnected after 15 s of silence (the reference delegates this to the
  WebRTC state machine, rtc.rs:166-174).
- **replay defense**: AEAD nonce counters are tracked per direction with an
  anti-replay window; a captured datagram replayed from a spoofed source
  can neither migrate the peer address nor be delivered twice.
- **candidate discovery / fallback**: ``stun_query`` learns the reflexive
  (ip, port) of THIS socket (rtc.rs:49-52 equivalent); ``join_relay``
  pivots the session through an encrypted-blind relay when punching fails
  (rtc.rs:55-63 TURN equivalent).
"""

from __future__ import annotations

import asyncio
import struct
import time
from typing import Dict, List, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.transport import relay as relay_mod
from p2p_llm_tunnel_tpu_torch.transport import stun
from p2p_llm_tunnel_tpu_torch.transport.arq import CWND_MIN, RTO_MIN, make_arq
from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.transport.crypto import CryptoError, SecureBox
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

REPLAY_WINDOW = 4096  # counters older than max-seen minus this are dropped

MTU_PAYLOAD = 1200  # fragment payload bytes per datagram
WINDOW = 512  # hard cap on unacked packets in flight (cwnd never exceeds it)
# RTO/cwnd constants live with the ARQ core (transport/arq.py, mirrored in
# native/tunnel_arq.cc); imported here for the maintenance tick and the
# SO_RCVBUF-derived cwnd cap.
KEEPALIVE_INTERVAL = 5.0
DEAD_TIMEOUT = 15.0
PUNCH_INTERVAL = 0.25

# packet types (first plaintext byte)
PT_PUNCH = 0
PT_PUNCH_ACK = 1
PT_DATA = 2
PT_ACK = 3
PT_CLOSE = 4

_DATA_HDR = struct.Struct(">BIB")  # type, seq, fin
_ACK_HDR = struct.Struct(">BI")  # type, cumulative ack (next expected seq)


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, channel: "UdpChannel") -> None:
        self._channel = channel

    def datagram_received(self, data: bytes, addr) -> None:
        self._channel._on_datagram(data, addr)

    def error_received(self, exc) -> None:
        log.debug("udp error: %s", exc)


class UdpChannel(Channel):
    """One P2P session over a UDP socket. Create via ``UdpChannel.bind``."""

    def __init__(self) -> None:
        super().__init__()
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._box: Optional[SecureBox] = None
        self._peer_addr: Optional[Tuple[str, int]] = None
        self._established = asyncio.Event()

        # sender state: ARQ/congestion bookkeeping lives in the swappable
        # core (transport/arq.py — native C++ when built, Python reference
        # otherwise); this class keeps only the packet BYTES per seq.
        self._next_seq = 0
        self._arq = make_arq(float(WINDOW))
        self._unacked: Dict[int, bytes] = {}  # seq → sealed packet
        self._window_free = asyncio.Event()
        self._window_free.set()

        # receiver state
        self._recv_next = 0
        self._out_of_order: Dict[int, Tuple[bytes, bool]] = {}
        self._partial = bytearray()
        self._ack_scheduled = False

        self._last_heard = time.monotonic()
        self._last_sent = time.monotonic()
        self._maint_task: Optional[asyncio.Task] = None

        # anti-replay state (AEAD nonce counters, one direction)
        self._replay_max = -1
        self._replay_seen: set = set()

        # STUN / relay machinery
        self._stun_waiters: Dict[bytes, asyncio.Future] = {}
        self._relay_joined = asyncio.Event()
        self._relay_reject: Optional[str] = None

    # -- setup ------------------------------------------------------------

    @classmethod
    async def bind(cls, host: str = "0.0.0.0", port: int = 0) -> "UdpChannel":
        ch = cls()
        loop = asyncio.get_running_loop()
        transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(ch), local_addr=(host, port)
        )
        ch._transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            # A full ARQ window (512 × ~1.2 KB) must fit the peer's kernel
            # receive buffer, or slow start overruns it and manufactures
            # loss on a clean path.  Ask for 2 MB (the kernel clamps to
            # rmem_max), then cap cwnd to what was actually granted — both
            # peers run this same stack, so the local grant is a sound
            # proxy for the remote one.
            try:
                sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, 2 << 20)
                sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, 2 << 20)
            except OSError:
                pass
            rcvbuf = sock.getsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF)
            ch._arq.set_cwnd_cap(float(
                max(CWND_MIN, min(WINDOW, rcvbuf // (2 * MTU_PAYLOAD)))
            ))
        return ch

    @property
    def local_port(self) -> int:
        return self._transport.get_extra_info("sockname")[1]

    @property
    def congestion_stats(self) -> dict:
        """Live ARQ/congestion state (observability + loss-injection tests)."""
        return {
            "srtt": self._arq.srtt,
            "rttvar": self._arq.rttvar,
            "rto": self._arq.rto,
            "cwnd": self._arq.cwnd,
            "ssthresh": self._arq.ssthresh,
            "retransmits": self._arq.retransmits,
            "in_flight": self._arq.in_flight,
            "native_arq": type(self._arq).__name__ == "NativeArq",
        }

    def set_session(self, box: SecureBox) -> None:
        """Install the derived session keys (before punching starts)."""
        self._box = box

    # -- candidate discovery / relay fallback ------------------------------

    async def stun_query(
        self, servers: List[Tuple[str, int]], timeout: float = 3.0
    ) -> Optional[Tuple[str, int]]:
        """Reflexive (ip, port) of THIS socket via the first STUN server to
        answer; None if none do.  Must run before/while punching — the
        mapping only matches if the query leaves the same socket."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        txids = []
        for addr in servers:
            pkt, txid = stun.build_binding_request()
            self._stun_waiters[txid] = fut
            txids.append(txid)
            try:
                self._transport.sendto(pkt, addr)
            except OSError as e:
                log.debug("stun send to %s failed: %s", addr, e)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            log.info("no STUN response from %s within %.1fs", servers, timeout)
            return None
        finally:
            for txid in txids:
                self._stun_waiters.pop(txid, None)

    async def join_relay(
        self, relay_addr: Tuple[str, int], token: str, timeout: float = 5.0,
        secret: Optional[str] = None,
    ) -> None:
        """Register with the pairing relay; raises TimeoutError if it never
        acks.  After this, punching against [relay_addr] rides the relay.
        ``secret`` authenticates the JOIN against a credentialed relay."""
        deadline = time.monotonic() + timeout
        pkt = relay_mod.join_packet(token, secret)
        self._relay_reject = None
        while not self._relay_joined.is_set():
            try:
                self._transport.sendto(pkt, relay_addr)
            except OSError as e:
                log.debug("relay join send failed: %s", e)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"relay {relay_addr} never acked join")
            try:
                await asyncio.wait_for(
                    self._relay_joined.wait(), min(0.25, remaining)
                )
            except asyncio.TimeoutError:
                continue
        if self._relay_reject is not None:
            reason, self._relay_reject = self._relay_reject, None
            self._relay_joined.clear()
            raise PermissionError(f"relay {relay_addr}: {reason}")
        log.info("joined relay %s (token %s…)", relay_addr, token[:8])

    async def punch(
        self, candidates: List[Tuple[str, int]], timeout: float = 10.0
    ) -> None:
        """Spray PUNCH probes at every candidate until the peer answers.

        Resolves when the first authenticated packet arrives (which locks
        the peer address); raises TimeoutError otherwise.
        """
        assert self._box is not None, "set_session before punch"
        if self._maint_task is None:
            self._maint_task = asyncio.create_task(self._maintenance())
        deadline = time.monotonic() + timeout
        while not self._established.is_set():
            for addr in candidates:
                self._send_control(PT_PUNCH, addr)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # The socket stays usable: the caller may retry against a
                # relay (connect.py fallback) or close the channel itself.
                raise TimeoutError(f"hole punch failed after {timeout}s")
            try:
                await asyncio.wait_for(
                    self._established.wait(), min(PUNCH_INTERVAL, remaining)
                )
            except asyncio.TimeoutError:
                continue
        log.info("udp channel established with %s", self._peer_addr)

    # -- wire helpers ------------------------------------------------------

    def _send_raw(self, plaintext: bytes, addr: Tuple[str, int]) -> None:
        if self._transport is None or self._transport.is_closing():
            return
        try:
            self._transport.sendto(self._box.seal(plaintext), addr)
            self._last_sent = time.monotonic()
        except OSError as e:
            log.debug("udp sendto failed: %s", e)

    def _send_control(self, ptype: int, addr: Optional[Tuple[str, int]] = None) -> None:
        addr = addr or self._peer_addr
        if addr is not None:
            self._send_raw(bytes([ptype]), addr)

    def _send_ack(self) -> None:
        if self._peer_addr is not None:
            self._send_raw(_ACK_HDR.pack(PT_ACK, self._recv_next), self._peer_addr)

    def _schedule_ack(self) -> None:
        """Coalesced (delayed) ACK: one cumulative ACK per event-loop batch
        of arrivals instead of one per data packet.  Per-packet ACKs under a
        full-window burst overflow the sender's UDP receive buffer, and the
        lost tail ACKs then masquerade as packet loss (spurious RTO
        retransmits + cwnd collapse on a clean path)."""
        if self._ack_scheduled:
            return
        self._ack_scheduled = True

        def flush() -> None:
            self._ack_scheduled = False
            if not self.is_closed:
                self._send_ack()

        asyncio.get_running_loop().call_soon(flush)

    # -- sending (reliable) -----------------------------------------------

    async def _send_impl(self, data: bytes) -> None:
        if not self._established.is_set():
            await self._established.wait()
        if self.is_closed:
            raise ChannelClosed("udp channel closed")
        # fragment into MTU payloads; fin marks the message boundary
        offsets = range(0, len(data), MTU_PAYLOAD) if data else [0]
        frags = [data[o : o + MTU_PAYLOAD] for o in offsets]
        for i, frag in enumerate(frags):
            while not self._arq.can_send():
                self._window_free.clear()
                await self._window_free.wait()
                if self.is_closed:
                    raise ChannelClosed("udp channel closed")
            seq = self._next_seq
            self._next_seq = (self._next_seq + 1) & 0xFFFFFFFF
            fin = 1 if i == len(frags) - 1 else 0
            pkt = _DATA_HDR.pack(PT_DATA, seq, fin) + frag
            self._unacked[seq] = pkt
            self._arq.on_send(seq, time.monotonic())
            self._send_raw(pkt, self._peer_addr)

    # -- receiving ---------------------------------------------------------

    def _on_datagram(self, wire: bytes, addr) -> None:
        # Out-of-band control traffic first: STUN responses and relay acks
        # are cleartext and structurally distinguishable from AEAD datagrams.
        if stun.is_stun_packet(wire):
            for txid, fut in list(self._stun_waiters.items()):
                parsed = stun.parse_binding_response(wire, txid)
                if parsed is not None and not fut.done():
                    fut.set_result(parsed)
                    break
            return
        if relay_mod.is_joined_packet(wire):
            self._relay_joined.set()
            return
        if relay_mod.is_reject_packet(wire):
            # Explicit relay NACK (auth required / bad credentials): record
            # the reason and wake join_relay so it fails fast and clearly
            # instead of timing out indistinguishably from an unreachable
            # relay.
            self._relay_reject = relay_mod.reject_reason(wire)
            self._relay_joined.set()
            return
        if self._box is None:
            return  # pre-handshake traffic: drop
        try:
            ctr, pkt = self._box.open_ctr(wire)
        except CryptoError:
            log.debug("dropping unauthenticated datagram from %s", addr)
            return
        if not pkt:
            return
        # Anti-replay: a captured datagram replayed from a spoofed source
        # must not migrate the peer address or be delivered twice.
        # Window-based so UDP reordering still delivers.
        if ctr <= self._replay_max - REPLAY_WINDOW or ctr in self._replay_seen:
            log.debug("dropping replayed datagram ctr=%d from %s", ctr, addr)
            return
        self._replay_seen.add(ctr)
        if ctr > self._replay_max:
            self._replay_max = ctr
            if len(self._replay_seen) > 2 * REPLAY_WINDOW:
                floor = self._replay_max - REPLAY_WINDOW
                self._replay_seen = {c for c in self._replay_seen if c > floor}
        self._last_heard = time.monotonic()
        ptype = pkt[0]

        # First authenticated packet locks the peer address (ICE-selected
        # pair equivalent); later valid fresh packets may migrate it (NAT
        # rebind) — replays were dropped above.
        if self._peer_addr != addr:
            self._peer_addr = addr
        if not self._established.is_set():
            self._established.set()
            self.connected.set()

        if ptype == PT_PUNCH:
            self._send_control(PT_PUNCH_ACK, addr)
        elif ptype == PT_PUNCH_ACK:
            pass  # liveness only
        elif ptype == PT_ACK and len(pkt) >= _ACK_HDR.size:
            _, cum = _ACK_HDR.unpack_from(pkt)
            self._handle_ack(cum)
        elif ptype == PT_DATA and len(pkt) >= _DATA_HDR.size:
            _, seq, fin = _DATA_HDR.unpack_from(pkt)
            self._handle_data(seq, bool(fin), pkt[_DATA_HDR.size :])
        elif ptype == PT_CLOSE:
            log.info("peer closed udp channel")
            self.close()

    def _handle_ack(self, cum: int) -> None:
        # Cumulative: everything strictly below `cum` is delivered.  The
        # ARQ core does the bookkeeping (Karn RTT sampling, AIMD growth);
        # this side just drops the acked packet bytes and wakes senders.
        for seq in self._arq.on_ack(cum, time.monotonic()):
            self._unacked.pop(seq, None)
        if self._arq.can_send():
            self._window_free.set()

    def _handle_data(self, seq: int, fin: bool, payload: bytes) -> None:
        if _seq_lt(seq, self._recv_next):
            self._send_ack()  # duplicate (likely a lost ACK): re-ack NOW
            return
        self._out_of_order[seq] = (payload, fin)
        while self._recv_next in self._out_of_order:
            frag, is_fin = self._out_of_order.pop(self._recv_next)
            self._recv_next = (self._recv_next + 1) & 0xFFFFFFFF
            self._partial.extend(frag)
            if is_fin:
                self._deliver(bytes(self._partial))
                self._partial.clear()
        self._schedule_ack()

    # -- maintenance -------------------------------------------------------

    async def _maintenance(self) -> None:
        """Retransmit timers, keepalives, dead-peer detection."""
        from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

        try:
            while not self.is_closed:
                await asyncio.sleep(RTO_MIN / 2)
                now = time.monotonic()
                # Congestion state as first-class gauges (SURVEY §5: the
                # rebuild exposes counters where the reference greps logs).
                # Gauges are last-writer-wins: meaningful for the normal
                # one-channel-per-process peers; multi-channel processes
                # should read per-channel congestion_stats instead.
                # Retransmits are a COUNTER (incremented at retransmit time
                # below) so they aggregate correctly across channels.
                global_metrics.set_gauge("transport_cwnd", self._arq.cwnd)
                global_metrics.set_gauge(
                    "transport_srtt_ms", (self._arq.srtt or 0.0) * 1000.0
                )
                global_metrics.set_gauge(
                    "transport_in_flight", float(self._arq.in_flight)
                )
                if self._established.is_set():
                    if now - self._last_heard > DEAD_TIMEOUT:
                        log.warning("udp peer silent for %.0fs; disconnecting",
                                    DEAD_TIMEOUT)
                        self.close()
                        return
                    # The ARQ core picks what to resend: expired (per-retry
                    # backed-off RTO) packets, oldest-first in mod-2^32
                    # order, paced by a cwnd-sized per-tick budget, with
                    # the once-per-RTT multiplicative decrease applied
                    # internally.
                    due = self._arq.due(now)
                    if due:
                        global_metrics.inc(
                            "transport_retransmits_total", len(due)
                        )
                    for seq in due:
                        pkt = self._unacked.get(seq)
                        if pkt is not None:
                            self._send_raw(pkt, self._peer_addr)
                    # Keepalive gates on time-since-last-SENT and uses PUNCH
                    # (which elicits a PUNCH_ACK), so an idle-but-healthy
                    # channel keeps both peers' last-heard clocks fresh.
                    if now - self._last_sent > KEEPALIVE_INTERVAL:
                        self._send_control(PT_PUNCH)
        except asyncio.CancelledError:
            pass

    def _close_impl(self) -> None:
        if self._peer_addr is not None and self._box is not None:
            self._send_control(PT_CLOSE)
        self._window_free.set()
        self._established.set()  # wake senders blocked pre-establishment
        if self._maint_task is not None and self._maint_task is not asyncio.current_task():
            self._maint_task.cancel()
        if self._transport is not None:
            self._transport.close()


def _seq_lt(a: int, b: int) -> bool:
    """a < b in mod-2^32 sequence space."""
    return ((a - b) & 0xFFFFFFFF) > 0x7FFFFFFF
