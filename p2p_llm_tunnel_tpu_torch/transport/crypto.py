"""Channel encryption: X25519 key agreement + ChaCha20-Poly1305 AEAD.

The reference's data channel is DTLS-encrypted by WebRTC (SURVEY.md §2 C5,
rtc.rs via the webrtc crate).  This is the equivalent for our native
transports: each peer publishes an ephemeral X25519 public key in its
offer/answer, both derive per-direction AEAD keys via HKDF, and every
message on the wire is sealed with a counter nonce.

The offerer encrypts with the "offer" key and decrypts with the "answer"
key; the answerer does the reverse — so the two directions never share a
nonce stream.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    HAVE_CRYPTO = True
except ImportError:  # gated optional dep: the loopback transport, the
    # frame/endpoint layers, and the engine need no crypto; only the real
    # UDP/TCP data planes do.  Importing must succeed so those layers stay
    # usable — constructing keys without the package raises clearly.
    HAVE_CRYPTO = False

NONCE_SIZE = 12
TAG_SIZE = 16


def _require_crypto() -> None:
    if not HAVE_CRYPTO:
        raise RuntimeError(
            "the 'cryptography' package is required for encrypted "
            "transports (pip install cryptography)"
        )


class HandshakeKeys:
    """One peer's ephemeral keypair and the derived session keys."""

    def __init__(self) -> None:
        _require_crypto()
        self._private = X25519PrivateKey.generate()
        self.public_bytes = self._private.public_key().public_bytes_raw()

    def derive(self, peer_public: bytes, offerer: bool, room: str) -> "SecureBox":
        """Derive the session box once the peer's public key arrives."""
        shared = self._private.exchange(X25519PublicKey.from_public_bytes(peer_public))
        okm = HKDF(
            algorithm=hashes.SHA256(),
            length=64,
            salt=b"p2p-llm-tunnel-tpu-v1",
            info=room.encode(),
        ).derive(shared)
        offer_key, answer_key = okm[:32], okm[32:]
        if offerer:
            return SecureBox(send_key=offer_key, recv_key=answer_key)
        return SecureBox(send_key=answer_key, recv_key=offer_key)


class CryptoError(Exception):
    """Decryption/authentication failure."""


class SecureBox:
    """Per-direction AEAD with explicit 8-byte counter nonces.

    The counter is carried on the wire (4 zero bytes + u64 BE), so packets
    surviving UDP reordering still decrypt; replay/ordering policy is the
    caller's job (the reliable layer orders by its own sequence numbers).
    """

    def __init__(self, send_key: bytes, recv_key: bytes) -> None:
        _require_crypto()
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_ctr = 0

    def seal(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce_ctr = self._send_ctr
        self._send_ctr += 1
        nonce = struct.pack(">4xQ", nonce_ctr)
        return nonce[4:] + self._send.encrypt(nonce, plaintext, aad or None)

    def open(self, wire: bytes, aad: bytes = b"") -> bytes:
        return self.open_ctr(wire, aad)[1]

    def open_ctr(self, wire: bytes, aad: bytes = b"") -> Tuple[int, bytes]:
        """Decrypt and also return the wire nonce counter, so the caller can
        enforce a replay policy (transport/udp.py drops repeated counters
        before allowing peer-address migration)."""
        if len(wire) < 8 + TAG_SIZE:
            raise CryptoError("ciphertext too short")
        nonce = b"\x00\x00\x00\x00" + wire[:8]
        try:
            plaintext = self._recv.decrypt(nonce, wire[8:], aad or None)
        except Exception as e:
            raise CryptoError(f"decryption failed: {e}") from e
        return struct.unpack(">Q", wire[:8])[0], plaintext


def random_session_id() -> str:
    return os.urandom(8).hex()
