"""Encrypted-blind UDP relay — the TURN-equivalent escape hatch.

When hole punching cannot succeed (symmetric / port-rewriting NATs on both
sides), the reference falls back to a TURN relay (reference
tunnel/src/rtc.rs:55-63; config surface cli.rs:72-77).  This is the native
equivalent: a dumb pairing relay that

- accepts ``JOIN <token>`` datagrams (magic-prefixed) and pairs the two
  sources that present the same token, answering each with ``JOINED``;
- thereafter forwards every non-JOIN datagram from one paired source to the
  other verbatim.

The relay never holds keys: channel datagrams are already sealed end-to-end
(X25519 + ChaCha20-Poly1305, transport/crypto.py), so the relay sees only
ciphertext — closer to TURN-over-DTLS than to a trusted middlebox.

Pairings idle out after IDLE_TIMEOUT so a public relay cannot leak forward
state forever.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import struct
import time
from typing import Dict, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGIC_JOIN = b"TPUTUNL1J"
MAGIC_JOIN_AUTH = b"TPUTUNL1A"
MAGIC_JOINED = b"TPUTUNL1K"
MAGIC_REJECT = b"TPUTUNL1R"  # + one reason byte (RJ_*)
IDLE_TIMEOUT = 120.0
MAX_TOKEN = 64
AUTH_WINDOW = 300.0  # max |now - ts| for an authenticated JOIN (replay bound)

_MAC_LEN = 32  # HMAC-SHA256


_NONCE_LEN = 8


def _join_mac(secret: str, token: str, ts: int, nonce: bytes) -> bytes:
    msg = token.encode() + b"|" + struct.pack(">Q", ts) + b"|" + nonce
    return hmac.new(secret.encode(), msg, hashlib.sha256).digest()


def join_packet(token: str, secret: Optional[str] = None,
                now: Optional[float] = None,
                nonce: Optional[bytes] = None) -> bytes:
    """Build a JOIN datagram; with ``secret`` it carries a timestamped,
    nonce-bound HMAC-SHA256 — the credentialed-relay surface of the
    reference's ``--turn-user/--turn-pass`` (cli.rs:72-77, rtc.rs:55-63).
    Without auth, anyone who observes the pairing token on the signaling
    channel can consume relay capacity.

    The nonce makes a captured JOIN non-replayable from another source:
    the relay pins each nonce to the first source address it arrives from
    (re-sends from the SAME address stay idempotent — join_relay retries
    the identical packet until acked)."""
    if secret is None:
        return MAGIC_JOIN + token.encode()
    import os

    ts = int(time.time() if now is None else now)
    nonce = os.urandom(_NONCE_LEN) if nonce is None else nonce
    assert len(nonce) == _NONCE_LEN
    body = token.encode()
    return (MAGIC_JOIN_AUTH + bytes([len(body)]) + body
            + struct.pack(">Q", ts) + nonce
            + _join_mac(secret, token, ts, nonce))


RJ_AUTH_REQUIRED = 1  # relay has a secret; JOIN was unauthenticated
RJ_BAD_AUTH = 2  # MAC invalid / stale / replayed


def is_joined_packet(data: bytes) -> bool:
    return data.startswith(MAGIC_JOINED)


def is_reject_packet(data: bytes) -> bool:
    return data.startswith(MAGIC_REJECT)


def reject_reason(data: bytes) -> str:
    code = data[len(MAGIC_REJECT)] if len(data) > len(MAGIC_REJECT) else 0
    return {
        RJ_AUTH_REQUIRED: "relay requires authentication (set --relay-secret)",
        RJ_BAD_AUTH: "relay rejected credentials (wrong/stale secret?)",
    }.get(code, f"relay rejected join (code {code})")


class _Pairing:
    __slots__ = ("addrs", "last_active")

    def __init__(self) -> None:
        self.addrs: list = []
        self.last_active = time.monotonic()


class RelayServer(asyncio.DatagramProtocol):
    """Pairing + forwarding state machine (one instance per socket).

    With ``secret`` set, only authenticated JOINs (fresh timestamp + valid
    HMAC over token‖ts) are honored — a public relay no longer pairs
    anyone who guessed or observed a token."""

    def __init__(self, secret: Optional[str] = None) -> None:
        self.transport: Optional[asyncio.DatagramTransport] = None
        self._secret = secret
        self._by_token: Dict[str, _Pairing] = {}
        self._by_addr: Dict[Tuple[str, int], Tuple[str, _Pairing]] = {}
        # nonce → (first source addr, first-seen time): a captured JOIN
        # replayed from a DIFFERENT address must not steal a pairing slot.
        self._nonces: Dict[bytes, Tuple[Tuple[str, int], float]] = {}
        self._warned_open_auth = False

    def connection_made(self, transport) -> None:
        self.transport = transport

    def _reject(self, addr, code: int) -> None:
        """Explicit NACK so a misconfigured client fails fast with a real
        reason instead of a generic 5 s join timeout.  Cleartext and thus
        spoofable in principle — same trust level as the JOIN/JOINED
        control plane itself (an off-path attacker lacks the client's
        ephemeral port); the data plane stays AEAD-sealed regardless."""
        if self.transport is not None:
            self.transport.sendto(MAGIC_REJECT + bytes([code]), addr)

    def _parse_join(self, data: bytes, addr) -> Optional[str]:
        """Returns the token of a JOIN this relay accepts, else None."""
        if data.startswith(MAGIC_JOIN_AUTH):
            rest = data[len(MAGIC_JOIN_AUTH):]
            if len(rest) < 1:
                return None
            tlen = rest[0]
            if tlen > MAX_TOKEN or len(rest) != 1 + tlen + 8 + _NONCE_LEN + _MAC_LEN:
                return None
            token = rest[1 : 1 + tlen].decode("ascii", "replace")
            (ts,) = struct.unpack_from(">Q", rest, 1 + tlen)
            nonce = rest[1 + tlen + 8 : 1 + tlen + 8 + _NONCE_LEN]
            mac = rest[1 + tlen + 8 + _NONCE_LEN :]
            if self._secret is None:
                # Fail-open visibility: the client presented credentials but
                # this relay verifies nothing — almost certainly an operator
                # who set TUNNEL_RELAY_SECRET on the peers and forgot
                # --secret on the relay.
                if not self._warned_open_auth:
                    self._warned_open_auth = True
                    log.warning(
                        "relay: received AUTHENTICATED join but relay runs "
                        "OPEN (no --secret) — credentials are NOT verified"
                    )
                return token
            if abs(time.time() - ts) > AUTH_WINDOW:
                log.warning("relay: stale JOIN for token %r dropped", token)
                self._reject(addr, RJ_BAD_AUTH)
                return None
            if not hmac.compare_digest(
                mac, _join_mac(self._secret, token, ts, nonce)
            ):
                log.warning("relay: bad JOIN MAC for token %r dropped", token)
                self._reject(addr, RJ_BAD_AUTH)
                return None
            now = time.monotonic()
            for n, (_, seen) in list(self._nonces.items()):
                if now - seen > AUTH_WINDOW:
                    del self._nonces[n]
            pinned = self._nonces.setdefault(nonce, (addr, now))
            if pinned[0] != addr:
                # Same bytes from a different source: a replay.  The real
                # client retries the IDENTICAL packet from ITS address
                # (idempotent), so this only rejects observers.
                log.warning("relay: replayed JOIN nonce from %s dropped", addr)
                return None
            return token
        if data.startswith(MAGIC_JOIN):
            if self._secret is not None:
                log.warning("relay: unauthenticated JOIN dropped (secret set)")
                self._reject(addr, RJ_AUTH_REQUIRED)
                return None
            return data[len(MAGIC_JOIN):][:MAX_TOKEN].decode("ascii", "replace")
        return None

    def _gc(self) -> None:
        now = time.monotonic()
        for token, pairing in list(self._by_token.items()):
            if now - pairing.last_active > IDLE_TIMEOUT:
                for a in pairing.addrs:
                    self._by_addr.pop(a, None)
                del self._by_token[token]

    def datagram_received(self, data: bytes, addr) -> None:
        self._gc()
        if data.startswith(MAGIC_JOIN) or data.startswith(MAGIC_JOIN_AUTH):
            token = self._parse_join(data, addr)
            if token is None:
                return
            pairing = self._by_token.setdefault(token, _Pairing())
            pairing.last_active = time.monotonic()
            if addr not in pairing.addrs:
                if len(pairing.addrs) >= 2:
                    log.warning("relay token %r already paired; ignoring %s",
                                token, addr)
                    return
                pairing.addrs.append(addr)
                self._by_addr[addr] = (token, pairing)
                log.info("relay: %s joined token %r (%d/2)",
                         addr, token, len(pairing.addrs))
            # Ack every JOIN (idempotent) so late/retried joiners sync up.
            self.transport.sendto(MAGIC_JOINED, addr)
            return
        entry = self._by_addr.get(addr)
        if entry is None:
            return  # not a participant; drop
        _, pairing = entry
        pairing.last_active = time.monotonic()
        for other in pairing.addrs:
            if other != addr:
                self.transport.sendto(data, other)


async def start_relay_server(
    host: str = "0.0.0.0", port: int = 0, secret: Optional[str] = None
) -> Tuple[asyncio.DatagramTransport, int]:
    """Bind a relay; returns (transport, bound_port). Close to stop."""
    loop = asyncio.get_running_loop()
    transport, _ = await loop.create_datagram_endpoint(
        lambda: RelayServer(secret), local_addr=(host, port)
    )
    bound = transport.get_extra_info("sockname")[1]
    log.info("relay server listening on %s:%d", host, bound)
    return transport, bound


async def run_relay_server(host: str = "0.0.0.0", port: int = 3479,
                           secret: Optional[str] = None) -> None:
    """CLI entry: serve until cancelled."""
    transport, _ = await start_relay_server(host, port, secret)
    try:
        await asyncio.Event().wait()
    finally:
        transport.close()


def parse_relay(spec: str) -> Tuple[str, int]:
    """'host[:port]' → (host, port)."""
    host, _, port = spec.partition(":")
    return host, int(port) if port else 3479
