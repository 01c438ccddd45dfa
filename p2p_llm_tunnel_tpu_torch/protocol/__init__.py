"""Wire protocol: binary frame codec + HELLO/AGREE negotiation.

Byte-compatible with the reference wire format (tunnel/src/protocol.rs:6-262)
so peers built here interoperate with the reference binary.
"""

from .frames import (
    PROTOCOL_VERSION,
    PROTOCOL_NAME,
    MAX_FRAME_SIZE,
    MAX_BODY_CHUNK,
    MessageType,
    Hello,
    Agree,
    RequestHeaders,
    ResponseHeaders,
    TunnelMessage,
    ProtocolError,
    NegotiationError,
)

__all__ = [
    "PROTOCOL_VERSION",
    "PROTOCOL_NAME",
    "MAX_FRAME_SIZE",
    "MAX_BODY_CHUNK",
    "MessageType",
    "Hello",
    "Agree",
    "RequestHeaders",
    "ResponseHeaders",
    "TunnelMessage",
    "ProtocolError",
    "NegotiationError",
]
