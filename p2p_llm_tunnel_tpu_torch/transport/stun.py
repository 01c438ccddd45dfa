"""Minimal STUN (RFC 5389) binding client + server.

The reference discovers its NAT-external candidate via ICE's STUN query to
``stun.l.google.com:19302`` (reference tunnel/src/rtc.rs:49-52).  This is the
native equivalent: a binding request sent from the SAME UDP socket the
channel will punch from (so the learned mapping is the one the peer must
hit), parsed for XOR-MAPPED-ADDRESS.

The server half is a tiny binding responder — enough to self-host candidate
discovery next to the signal server (and to test the client offline; this
build environment has zero egress to public STUN).
"""

from __future__ import annotations

import asyncio
import os
import socket
import struct
from typing import Optional, Tuple

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGIC_COOKIE = 0x2112A442
BINDING_REQUEST = 0x0001
BINDING_RESPONSE = 0x0101
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_XOR_MAPPED_ADDRESS = 0x0020

_HDR = struct.Struct(">HHI12s")  # type, length, cookie, txid

#: The reference's default STUN server (rtc.rs:50).
DEFAULT_STUN = "stun.l.google.com:19302"


def build_binding_request(txid: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """Returns (packet, txid)."""
    txid = txid or os.urandom(12)
    return _HDR.pack(BINDING_REQUEST, 0, MAGIC_COOKIE, txid), txid


def is_stun_packet(data: bytes) -> bool:
    """STUN demux rule: first two bits 00 + magic cookie at offset 4 —
    never collides with our AEAD datagrams' random-looking bytes in any way
    that matters (a false positive is simply dropped by the STUN parser)."""
    return (
        len(data) >= _HDR.size
        and (data[0] & 0xC0) == 0
        and struct.unpack_from(">I", data, 4)[0] == MAGIC_COOKIE
    )


def parse_binding_response(
    data: bytes, txid: bytes
) -> Optional[Tuple[str, int]]:
    """Extract the reflexive (ip, port) from a binding response, else None."""
    if len(data) < _HDR.size:
        return None
    mtype, length, cookie, rx_txid = _HDR.unpack_from(data)
    if mtype != BINDING_RESPONSE or cookie != MAGIC_COOKIE or rx_txid != txid:
        return None
    off, end = _HDR.size, min(len(data), _HDR.size + length)
    fallback = None
    while off + 4 <= end:
        atype, alen = struct.unpack_from(">HH", data, off)
        aval = data[off + 4 : off + 4 + alen]
        off += 4 + ((alen + 3) & ~3)  # attributes pad to 32-bit
        if len(aval) < 8 or aval[1] != 0x01:  # IPv4 family only
            continue
        port = struct.unpack_from(">H", aval, 2)[0]
        ip_bytes = aval[4:8]
        if atype == ATTR_XOR_MAPPED_ADDRESS:
            port ^= MAGIC_COOKIE >> 16
            ip_bytes = bytes(
                b ^ m for b, m in zip(ip_bytes, struct.pack(">I", MAGIC_COOKIE))
            )
            return socket.inet_ntoa(ip_bytes), port
        if atype == ATTR_MAPPED_ADDRESS:
            fallback = (socket.inet_ntoa(ip_bytes), port)
    return fallback


def build_binding_response(txid: bytes, addr: Tuple[str, int]) -> bytes:
    """Server side: XOR-MAPPED-ADDRESS response for ``addr``."""
    ip_bytes = bytes(
        b ^ m
        for b, m in zip(socket.inet_aton(addr[0]), struct.pack(">I", MAGIC_COOKIE))
    )
    attr = struct.pack(
        ">HHBBH", ATTR_XOR_MAPPED_ADDRESS, 8, 0, 0x01,
        addr[1] ^ (MAGIC_COOKIE >> 16),
    ) + ip_bytes
    return _HDR.pack(BINDING_RESPONSE, len(attr), MAGIC_COOKIE, txid) + attr


def parse_server(spec: str) -> Tuple[str, int]:
    """'host[:port]' → (host, port); scheme prefix 'stun:' accepted."""
    spec = spec.removeprefix("stun:")
    host, _, port = spec.partition(":")
    return host, int(port) if port else 3478


class _ServerProto(asyncio.DatagramProtocol):
    def __init__(self) -> None:
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        if not is_stun_packet(data):
            return
        mtype, _, _, txid = _HDR.unpack_from(data)
        if mtype != BINDING_REQUEST:
            return
        log.debug("stun binding request from %s", addr)
        self.transport.sendto(build_binding_response(txid, addr), addr)


async def run_stun_server(host: str = "0.0.0.0", port: int = 3478):
    """Serve binding responses until cancelled. Returns the bound port."""
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _ServerProto, local_addr=(host, port)
    )
    bound = transport.get_extra_info("sockname")[1]
    log.info("stun server listening on %s:%d", host, bound)
    try:
        await asyncio.Event().wait()
    finally:
        transport.close()


async def start_stun_server(
    host: str = "127.0.0.1", port: int = 0
) -> Tuple[asyncio.DatagramTransport, int]:
    """Test/embedding helper: returns (transport, bound_port)."""
    loop = asyncio.get_running_loop()
    transport, _ = await loop.create_datagram_endpoint(
        _ServerProto, local_addr=(host, port)
    )
    return transport, transport.get_extra_info("sockname")[1]
