"""Binary tunnel frame codec and handshake negotiation.

Frame layout (wire-compatible with reference tunnel/src/protocol.rs:148-172):

    [type: u8][stream_id: u32 big-endian][payload: bytes]

Control payloads (Hello/Agree/Req-/ResHeaders/Error) are UTF-8 JSON; body
payloads are raw bytes. Eleven message types match the reference
(protocol.rs:88-100); FLOW (per-stream credit), RES_RESUME/RES_RESUMED
(mid-stream continuity) and the KV_PAGES_* family (disaggregated
prefill/decode page transfer) are protocol-v2 extensions the
HELLO/AGREE negotiation was designed to allow.

The handshake (reference protocol.rs:17-81): the proxy peer sends HELLO
advertising a protocol name, a [min_version, max_version] range, and a feature
list; the serve peer answers AGREE with the highest overlapping version and the
intersection of features. The only v1 feature is "sse".

Intentional divergence from the reference: ``decode()`` rejects frames larger
than MAX_FRAME_SIZE, which the reference decoder tolerates (protocol.rs:
157-172 has no size check). Both encoders only ever *emit* frames within the
cap, so compliant peers are unaffected; rejecting oversize input here bounds
memory for a frame that should never exist on the wire.
"""

from __future__ import annotations

import enum
import hashlib
import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PROTOCOL_VERSION = 1
PROTOCOL_NAME = "httptunnel"

#: Hard cap on a single encoded frame (reference protocol.rs:10). Keeps frames
#: under typical data-channel message limits.
MAX_FRAME_SIZE = 64 * 1024
#: Max body bytes per REQ_BODY/RES_BODY frame, leaving slack for the 5-byte
#: header + transport overhead (reference protocol.rs:12).
MAX_BODY_CHUNK = MAX_FRAME_SIZE - 128

#: Features this implementation supports.  "sse" is the reference's only
#: feature (protocol.rs:67); "flow" is our per-stream credit flow control —
#: the protocol-v2 extension the reference's HELLO/AGREE negotiation was
#: designed to allow (SURVEY.md §7 hard-part #3: the reference has no
#: backpressure).  Reference peers never offer "flow", so the intersection
#: disables it and the wire stays reference-compatible.  "kvpages" gates
#: the KV_PAGES_* transfer family: ``decode()`` rejects unknown
#: type bytes, so a peer may only ever be SENT KV frames after it
#: advertised the feature in its own HELLO/AGREE — legacy peers never see
#: them and the request wire stays byte-identical.
SUPPORTED_FEATURES = ["sse", "flow", "kvpages"]

#: Initial per-stream credit a serve peer assumes when "flow" is agreed;
#: the proxy replenishes with FLOW frames as its client consumes.
INITIAL_CREDIT = 256 * 1024
#: Proxy grants more credit once it has relayed this many bytes.
CREDIT_BATCH = 64 * 1024

#: Registry of machine-readable ``[code]`` prefixes for typed ERROR frames
#: (:meth:`TunnelMessage.typed_error` / :meth:`TunnelMessage.error_code`).
#: Peers dispatch on these strings, so the vocabulary is a wire contract:
#: new codes must be added here, never minted inline — enforced statically
#: by tunnelcheck rule TC05 (typed_error literals and ``tunnel_code`` class
#: attributes both).
#:
#:   timeout  — the request blew its x-tunnel-deadline-ms budget
#:   busy     — shed by admission control (scheduler queue or max_inflight)
#:   draining — server is draining; retry against another peer
#:   upstream — the backend failed mid-stream
#:   tenant_overlimit — shed by tenant-fair admission: THIS tenant is over
#:     its weighted share of a contended ingress (other tenants are not);
#:     backing off helps, switching API keys is the attack the code exists
#:     to make visible
#:   peer_lost — the serve peer carrying this stream died mid-flight and no
#:     surviving peer could transparently absorb it (requests that had not
#:     yet streamed are re-dispatched instead of surfacing this); safe to
#:     retry after the advertised Retry-After
#:   tunnel_reset — the proxy itself is tearing the tunnel down (shutdown
#:     or full reconnect); unlike peer_lost there is no surviving peer to
#:     absorb anything — retry against the listener once it returns
#:   memory — shed by the KV memory degradation contract: both
#:     tiers are exhausted — the HBM page pool is fully reserved AND the
#:     host spill tier is at capacity.  Backing off (or routing to another
#:     peer — fabric health carries engine_degraded_reason="memory")
#:     helps; retrying instantly just thrashes the pool the code exists to
#:     protect
#:   page_pin — a KV_PAGES transfer was refused: the offered pages' pin
#:     metadata (model/dtype/quant/group-size/kv-quant/seed/ckpt/block)
#:     does not match the receiving pool, or a payload failed its
#:     checksum.  Only ever carried on a dedicated transfer stream, never
#:     a request stream — the handoff orchestrator treats it as "ship
#:     nothing" and the decode peer re-prefills locally, so the client
#:     request proceeds unperturbed
ERROR_CODES = frozenset(
    {"timeout", "busy", "draining", "upstream", "tenant_overlimit",
     "peer_lost", "tunnel_reset", "memory", "page_pin"}
)

_HEADER = struct.Struct(">BI")  # type:u8, stream_id:u32 BE


class ProtocolError(Exception):
    """Malformed frame: truncated header, unknown type byte, oversize, bad JSON."""


class NegotiationError(Exception):
    """HELLO/AGREE negotiation failed (wrong protocol or disjoint versions)."""


class MessageType(enum.IntEnum):
    """Frame type tags (reference protocol.rs:88-100)."""

    HELLO = 1
    AGREE = 2
    PING = 3
    PONG = 4
    REQ_HEADERS = 10
    REQ_BODY = 11
    REQ_END = 12
    RES_HEADERS = 20
    RES_BODY = 21
    RES_END = 22
    #: Mid-stream continuity: the proxy asks a serve peer to
    #: splice a parked stream's replay journal at its delivered-byte
    #: offset onto THIS stream id; payload = JSON (token, offset, epoch).
    RES_RESUME = 23
    #: The serve peer's acceptance: journal bytes >= offset follow as
    #: ordinary RES_BODY frames on the same stream id, then RES_END.
    #: A resume the serve peer cannot honor (unknown/expired token,
    #: trimmed offset) is answered with a typed ``peer_lost`` ERROR
    #: frame instead — never silence.
    RES_RESUMED = 24
    FLOW = 30  # per-stream credit grant: payload = u32 BE byte count
    #: Disaggregated prefill/decode page transfer.  The family
    #: rides DEDICATED streams — never a request stream — so a refused or
    #: half-delivered transfer cannot perturb any in-flight HTTP request,
    #: and it is only ever sent to a peer that negotiated the "kvpages"
    #: feature (decode() rejects unknown type bytes on legacy peers).
    #: HDR: JSON KvPagesManifest — chain-ordered page specs + pin meta.
    KV_PAGES_HDR = 40
    #: Raw page bytes, chunked like RES_BODY and subject to the same FLOW
    #: credit when negotiated: pages in manifest order, each page's leaves
    #: concatenated in sorted-name order, contiguous C-order bytes.
    KV_PAGES_CHUNK = 41
    KV_PAGES_END = 42  # transfer complete; receiver verifies + splices
    #: Receiver's verdict: JSON {"spliced": n}.  A pin/checksum refusal is
    #: a typed ``page_pin`` ERROR on the transfer stream instead.
    KV_PAGES_ACK = 43
    ERROR = 99

    @classmethod
    def from_u8(cls, v: int) -> "MessageType | None":
        try:
            return cls(v)
        except ValueError:
            return None


@dataclass
class Hello:
    """Handshake opener (reference protocol.rs:17-38). JSON keys: proto,
    min_version, max_version, features — plus the OPTIONAL fabric
    extension key ``peer``: a fabric proxy stamps the peer id it
    assigned this link, so the serve side can tag its spans and /healthz
    with the identity the proxy's fleet surfaces know it by.  Omitted from
    the wire when empty, so classic 2-peer handshakes stay byte-identical
    to the reference; unknown-key-tolerant peers ignore it."""

    proto: str = PROTOCOL_NAME
    min_version: int = 1
    max_version: int = PROTOCOL_VERSION
    features: List[str] = field(default_factory=lambda: list(SUPPORTED_FEATURES))
    peer: str = ""

    def to_json(self) -> bytes:
        obj = {
            "proto": self.proto,
            "min_version": self.min_version,
            "max_version": self.max_version,
            "features": self.features,
        }
        if self.peer:
            obj["peer"] = self.peer
        return json.dumps(obj).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Hello":
        try:
            obj = json.loads(data)
            return cls(
                proto=obj["proto"],
                min_version=int(obj["min_version"]),
                max_version=int(obj["max_version"]),
                features=list(obj["features"]),
                peer=str(obj.get("peer", "")),
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad HELLO payload: {e}") from e


@dataclass
class Agree:
    """Handshake reply carrying the negotiated version + feature intersection
    (reference protocol.rs:25-81).

    ``role`` is the OPTIONAL disaggregation extension key: a
    serve peer running a role-split engine advertises ``prefill`` or
    ``decode`` so the proxy's PeerSet can route admission accordingly.
    Omitted from the wire for the default ``both`` — classic handshakes
    stay byte-identical to the reference — and ignored by legacy peers
    (unknown-key-tolerant JSON), following the Hello.peer pattern.
    """

    version: int = PROTOCOL_VERSION
    features: List[str] = field(default_factory=lambda: list(SUPPORTED_FEATURES))
    role: str = "both"

    def to_json(self) -> bytes:
        obj: Dict[str, object] = {
            "version": self.version, "features": self.features,
        }
        if self.role and self.role != "both":
            obj["role"] = self.role
        return json.dumps(obj).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Agree":
        try:
            obj = json.loads(data)
            return cls(
                version=int(obj["version"]),
                features=list(obj["features"]),
                role=str(obj.get("role", "both") or "both"),
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad AGREE payload: {e}") from e

    @classmethod
    def from_hello(cls, hello: Hello) -> "Agree":
        """Negotiate: highest overlapping version, feature-set intersection.

        Raises NegotiationError on unknown protocol name or disjoint version
        ranges (reference protocol.rs:44-81).
        """
        if hello.proto != PROTOCOL_NAME:
            raise NegotiationError(f"unknown protocol: {hello.proto}")
        our_min, our_max = 1, PROTOCOL_VERSION
        overlap_min = max(hello.min_version, our_min)
        overlap_max = min(hello.max_version, our_max)
        if overlap_min > overlap_max:
            raise NegotiationError(
                f"no compatible version: peer=[{hello.min_version},{hello.max_version}],"
                f" ours=[{our_min},{our_max}]"
            )
        agreed = [f for f in hello.features if f in SUPPORTED_FEATURES]
        return cls(version=overlap_max, features=agreed)


@dataclass
class RequestHeaders:
    """REQ_HEADERS JSON payload (reference protocol.rs:123-128)."""

    stream_id: int
    method: str
    path: str
    headers: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "stream_id": self.stream_id,
                "method": self.method,
                "path": self.path,
                "headers": self.headers,
            }
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "RequestHeaders":
        try:
            obj = json.loads(data)
            return cls(
                stream_id=int(obj["stream_id"]),
                method=str(obj["method"]),
                path=str(obj["path"]),
                headers=dict(obj["headers"]),
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad REQ_HEADERS payload: {e}") from e


@dataclass
class ResponseHeaders:
    """RES_HEADERS JSON payload (reference protocol.rs:132-136).

    ``resume``/``grace`` are the OPTIONAL mid-stream-continuity extension
   : for a resumable stream the serve peer mints a resume
    token and advertises how long a detached stream parks before its
    engine generation is cancelled.  Omitted from the wire when empty —
    non-resumable responses stay byte-identical to the reference — and
    carried as payload extension keys (unknown-key-tolerant JSON), so
    legacy peers relay the response unchanged and never see the token.
    """

    stream_id: int
    status: int
    headers: Dict[str, str] = field(default_factory=dict)
    resume: str = ""
    grace: float = 0.0

    def to_json(self) -> bytes:
        obj = {
            "stream_id": self.stream_id,
            "status": self.status,
            "headers": self.headers,
        }
        if self.resume:
            obj["resume"] = self.resume
            obj["grace"] = self.grace
        return json.dumps(obj).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ResponseHeaders":
        try:
            obj = json.loads(data)
            return cls(
                stream_id=int(obj["stream_id"]),
                status=int(obj["status"]),
                headers=dict(obj["headers"]),
                resume=str(obj.get("resume", "")),
                grace=float(obj.get("grace", 0.0) or 0.0),
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad RES_HEADERS payload: {e}") from e


#: Longest resume token accepted off the wire: tokens are serve-minted
#: (short), so anything longer is a malformed or hostile frame — bounding
#: it keeps the detached-stream registry lookup key small.
MAX_RESUME_TOKEN_LEN = 64


@dataclass
class ResumeFrame:
    """RES_RESUME / RES_RESUMED JSON payload.

    ``token`` names the parked stream in the serve peer's detached-stream
    registry; ``offset`` is an absolute response-body byte offset — the
    proxy sends the bytes it has DELIVERED to its HTTP client, and the
    serve peer splices its replay journal at exactly that byte, so the
    client-observed body is byte-identical to an uninterrupted run.
    ``epoch`` counts successful reattachments: the proxy echoes the last
    epoch it saw (0 for the original attachment) and the serve peer
    answers with the incremented value, so a stale or duplicate
    RES_RESUME can never splice a stream twice.
    """

    stream_id: int
    token: str
    offset: int
    epoch: int = 0

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "stream_id": self.stream_id,
                "token": self.token,
                "offset": self.offset,
                "epoch": self.epoch,
            }
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ResumeFrame":
        try:
            obj = json.loads(data)
            token = str(obj["token"])
            offset = int(obj["offset"])
            epoch = int(obj.get("epoch", 0))
            if len(token) > MAX_RESUME_TOKEN_LEN or offset < 0 or epoch < 0:
                raise ValueError("token/offset/epoch out of bounds")
            return cls(
                stream_id=int(obj["stream_id"]),
                token=token,
                offset=offset,
                epoch=epoch,
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad RES_RESUME payload: {e}") from e


#: Most pages one KV_PAGES transfer may carry: the manifest must fit a
#: single frame (``encode()`` raises past MAX_FRAME_SIZE), and pages are a
#: CHAIN PREFIX — the prefix index matches from the root — so a longer
#: prompt ships its first 64 pages and the decode peer prefills the tail
#: it would have prefilled anyway.  Also the off-the-wire bound: a hostile
#: manifest cannot make the receiver pre-allocate unbounded splice state.
MAX_KV_PAGES_PER_XFER = 64


@dataclass
class KvPagesManifest:
    """KV_PAGES_HDR JSON payload: what the chunk bytes mean.

    ``meta`` is the sender's pool pin metadata — the same dict
    ``verify_page_pin`` checks on every spill page-in — so the receiver
    can refuse (typed ``page_pin``) BEFORE any bytes land.  ``pages`` is
    chain-ordered (root first, matching the prefix index's walk): each
    entry names the page's content-addressed chain key, its blake2b-16
    payload checksum, its leaf specs ``{name: {"shape": [...], "dtype":
    str}}`` and total byte count, so the receiver can slice the
    concatenated KV_PAGES_CHUNK stream back into per-leaf arrays without
    trusting byte counts it cannot verify.
    """

    stream_id: int
    meta: Dict[str, object] = field(default_factory=dict)
    pages: List[Dict[str, object]] = field(default_factory=list)

    def total_bytes(self) -> int:
        """Chunk-stream length the receiver should expect."""
        return sum(int(p["nbytes"]) for p in self.pages)

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "stream_id": self.stream_id,
                "meta": self.meta,
                "pages": self.pages,
            }
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "KvPagesManifest":
        try:
            obj = json.loads(data)
            pages = list(obj["pages"])
            if len(pages) > MAX_KV_PAGES_PER_XFER:
                raise ValueError(
                    f"manifest carries {len(pages)} pages "
                    f"(max {MAX_KV_PAGES_PER_XFER})"
                )
            for p in pages:
                # Every field the splice path dereferences, checked here
                # so a malformed manifest fails as a ProtocolError at the
                # frame boundary, not a KeyError deep in the engine.
                str(p["key"]), str(p["checksum"])
                if int(p["nbytes"]) < 0:
                    raise ValueError("negative page nbytes")
                for spec in dict(p["leaves"]).values():
                    list(spec["shape"]), str(spec["dtype"])
            return cls(
                stream_id=int(obj["stream_id"]),
                meta=dict(obj["meta"]),
                pages=pages,
            )
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad KV_PAGES_HDR payload: {e}") from e


@dataclass
class TunnelMessage:
    """One framed tunnel message (reference protocol.rs:140-262)."""

    msg_type: MessageType
    stream_id: int
    payload: bytes = b""

    # -- codec ------------------------------------------------------------

    def encode(self) -> bytes:
        out = _HEADER.pack(int(self.msg_type), self.stream_id) + self.payload
        if len(out) > MAX_FRAME_SIZE:
            raise ProtocolError(
                f"frame too large: {len(out)} > {MAX_FRAME_SIZE}"
            )
        return out

    @classmethod
    def decode(cls, data: bytes) -> "TunnelMessage":
        if len(data) < _HEADER.size:
            raise ProtocolError(f"frame too short: {len(data)} bytes")
        if len(data) > MAX_FRAME_SIZE:
            raise ProtocolError(f"frame too large: {len(data)} > {MAX_FRAME_SIZE}")
        type_byte, stream_id = _HEADER.unpack_from(data)
        msg_type = MessageType.from_u8(type_byte)
        if msg_type is None:
            raise ProtocolError(f"unknown message type: {type_byte}")
        return cls(msg_type=msg_type, stream_id=stream_id, payload=bytes(data[5:]))

    # -- convenience constructors (reference protocol.rs:176-262) ---------

    @classmethod
    def hello(cls, hello: Hello | None = None) -> "TunnelMessage":
        return cls(MessageType.HELLO, 0, (hello or Hello()).to_json())

    @classmethod
    def agree(cls, agree: Agree) -> "TunnelMessage":
        return cls(MessageType.AGREE, 0, agree.to_json())

    @classmethod
    def ping(cls) -> "TunnelMessage":
        return cls(MessageType.PING, 0)

    @classmethod
    def pong(cls) -> "TunnelMessage":
        return cls(MessageType.PONG, 0)

    @classmethod
    def req_headers(cls, headers: RequestHeaders) -> "TunnelMessage":
        return cls(MessageType.REQ_HEADERS, headers.stream_id, headers.to_json())

    @classmethod
    def req_body(cls, stream_id: int, data: bytes) -> "TunnelMessage":
        return cls(MessageType.REQ_BODY, stream_id, data)

    @classmethod
    def req_end(cls, stream_id: int) -> "TunnelMessage":
        return cls(MessageType.REQ_END, stream_id)

    @classmethod
    def res_headers(cls, headers: ResponseHeaders) -> "TunnelMessage":
        return cls(MessageType.RES_HEADERS, headers.stream_id, headers.to_json())

    @classmethod
    def res_body(cls, stream_id: int, data: bytes) -> "TunnelMessage":
        return cls(MessageType.RES_BODY, stream_id, data)

    @classmethod
    def res_end(cls, stream_id: int) -> "TunnelMessage":
        return cls(MessageType.RES_END, stream_id)

    @classmethod
    def error(cls, stream_id: int, msg: str) -> "TunnelMessage":
        # ERROR payload is plain UTF-8 text (reference protocol.rs:240-246).
        return cls(MessageType.ERROR, stream_id, msg.encode())

    @classmethod
    def typed_error(cls, stream_id: int, code: str, msg: str) -> "TunnelMessage":
        """ERROR frame with a machine-readable ``[code]`` prefix.

        The payload stays plain UTF-8 text — reference peers render it
        verbatim — but robustness-aware peers can dispatch on the code
        (``timeout`` / ``busy`` / ``draining`` / ``upstream``) via
        :meth:`error_code` instead of string-matching free text.
        """
        return cls.error(stream_id, f"[{code}] {msg}")

    def error_code(self) -> Optional[str]:
        """The ``[code]`` of a typed ERROR frame, or None for plain text."""
        if self.msg_type != MessageType.ERROR:
            return None
        text = self.payload.decode("utf-8", "replace")
        if text.startswith("[") and "]" in text:
            return text[1 : text.index("]")]
        return None

    @classmethod
    def res_resume(cls, frame: ResumeFrame) -> "TunnelMessage":
        return cls(MessageType.RES_RESUME, frame.stream_id, frame.to_json())

    @classmethod
    def res_resumed(cls, frame: ResumeFrame) -> "TunnelMessage":
        return cls(MessageType.RES_RESUMED, frame.stream_id, frame.to_json())

    @classmethod
    def flow(cls, stream_id: int, credit: int) -> "TunnelMessage":
        """Grant ``credit`` more response-body bytes for one stream."""
        return cls(MessageType.FLOW, stream_id, struct.pack(">I", credit))

    def flow_credit(self) -> int:
        if len(self.payload) < 4:
            raise ProtocolError("FLOW payload must be a u32 credit")
        return struct.unpack_from(">I", self.payload)[0]

    @classmethod
    def kv_pages_hdr(cls, manifest: KvPagesManifest) -> "TunnelMessage":
        return cls(MessageType.KV_PAGES_HDR, manifest.stream_id,
                   manifest.to_json())

    @classmethod
    def kv_pages_chunk(cls, stream_id: int, data: bytes) -> "TunnelMessage":
        return cls(MessageType.KV_PAGES_CHUNK, stream_id, data)

    @classmethod
    def kv_pages_end(cls, stream_id: int) -> "TunnelMessage":
        return cls(MessageType.KV_PAGES_END, stream_id)

    @classmethod
    def kv_pages_ack(cls, stream_id: int, spliced: int) -> "TunnelMessage":
        return cls(MessageType.KV_PAGES_ACK, stream_id,
                   json.dumps({"spliced": int(spliced)}).encode())

    def kv_ack_spliced(self) -> int:
        """Pages the receiver spliced, from a KV_PAGES_ACK payload."""
        try:
            return int(json.loads(self.payload)["spliced"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad KV_PAGES_ACK payload: {e}") from e


#: Optional per-request time budget, in milliseconds, set by the client.
#: Enforced by the serve endpoint (frame relay) and the engine scheduler
#: (slot eviction).  A wire convention, so it lives with the frame codec —
#: both the endpoints and the engine layers consume it.
DEADLINE_HEADER = "x-tunnel-deadline-ms"


def parse_deadline_ms(headers: Dict[str, str]) -> "Optional[float]":
    """The request's ``x-tunnel-deadline-ms`` budget, or None.

    Malformed or non-positive values are ignored with a warning — a bad
    hint must never fail a request that would otherwise succeed.
    """
    from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

    for k, v in headers.items():
        if k.lower() == DEADLINE_HEADER:
            try:
                ms = float(v)
            except (TypeError, ValueError):
                get_logger(__name__).warning(
                    "ignoring malformed %s: %r", DEADLINE_HEADER, v
                )
                return None
            return ms if ms > 0 else None
    return None


#: Tenant identity header: stamped at the proxy ingress from an
#: explicit ``x-tunnel-tenant`` or the fingerprint of the client's API key
#: (``x-api-key``), falling back to the room/connection name — carried in
#: RequestHeaders.headers across the tunnel so serve + the engine account
#: and fair-admit per tenant.  A wire convention like the deadline header,
#: so it lives with the frame codec.
TENANT_HEADER = "x-tunnel-tenant"
#: Client-facing API-key header the proxy maps to a tenant identity.
API_KEY_HEADER = "x-api-key"
#: Longest tenant identity carried on the wire; longer values truncate so
#: an adversarial header cannot bloat per-tenant accounting keys.
MAX_TENANT_LEN = 64

#: Response header carrying a typed tunnel-error code alongside an HTTP
#: error body (e.g. a 429 from the engine API): the serve loop pops it
#: before relaying and follows RES_END with the matching typed ERROR frame,
#: so protocol-aware peers get the same dispatchable code whether the shed
#: happened at the tunnel layer or inside the backend.
ERROR_CODE_HEADER = "x-tunnel-error-code"

#: Request header marking a disaggregated KV-export probe: the
#: proxy tags an otherwise-normal generation request with it and sends it
#: to a prefill-role peer, which answers in the KV_PAGES vocabulary (HDR +
#: CHUNK* + END on the same stream) instead of RES_* — or a plain ERROR
#: frame when it has nothing useful to ship.  Never forwarded to HTTP
#: upstreams (it rides the tunnel only between proxy and serve).
KV_EXPORT_HEADER = "x-tunnel-kv-export"


def tenant_fingerprint(api_key: str) -> str:
    """Stable accounting label for an API key: ``key-`` + 12 hex chars of
    its SHA-256.  The tenant identity is exported on unauthenticated
    surfaces (/metrics labels, /healthz, trace attrs), so the credential
    itself must never BE the identity — the fingerprint keeps same-key
    requests in one bucket without leaking the secret to any scraper."""
    return "key-" + hashlib.sha256(api_key.encode()).hexdigest()[:12]


def parse_tenant(headers: Dict[str, str], fallback: str = "",
                 trust_label: bool = True) -> str:
    """The request's tenant identity, or ``fallback`` when untagged.

    ``x-tunnel-tenant`` (the canonical tunnel header, an operator-chosen
    label, used verbatim) wins over ``x-api-key`` (a CREDENTIAL — mapped
    through :func:`tenant_fingerprint`, never used raw).  Values are
    stripped and truncated to MAX_TENANT_LEN; a present-but-empty header
    means "untagged", never an empty-string tenant key.

    ``trust_label=False`` ignores the explicit label entirely — the
    public-ingress posture: a client minting a fresh x-tunnel-tenant per
    request would otherwise sidestep its own fair-share cap AND crush
    every legitimate tenant's share toward the floor of 1.  Inside the
    tunnel the header is proxy-stamped and trusted (the default); at the
    proxy's HTTP listener it is honored only behind an operator opt-in
    (``--trust-tenant-header``, for deployments where a trusted edge
    stamps it), so minting identities requires distinct API keys.

    CAVEAT: nothing in this stack VALIDATES API keys — the fingerprint
    makes same-key traffic accountable, it does not authenticate.  At a
    truly public listener an attacker can still mint identities by
    varying x-api-key; the per-tenant metric registry is bounded
    (TENANT_CAP + ~other overflow) but fair-share caps dilute as the
    active-tenant set grows.  Fairness guarantees assume the edge in
    front of this proxy rejects unknown credentials (README "Operating
    at scale"); authenticated key validation is a ROADMAP follow-up.
    """
    explicit = api_key = ""
    for k, v in headers.items():
        lk = k.lower()
        if lk == TENANT_HEADER:
            if trust_label:
                explicit = v.strip()
        elif lk == API_KEY_HEADER:
            api_key = v.strip()
    out = explicit or (tenant_fingerprint(api_key) if api_key else "") or fallback
    return out[:MAX_TENANT_LEN]


#: Optional trace-context header (``<trace_id>/<parent_span_id>``): minted
#: at the proxy, carried in RequestHeaders.headers across the tunnel, and
#: picked up by serve + the engine — the x-tunnel-deadline-ms precedent.
#: Defined (with its parser) in utils/tracing.py, which owns the span
#: vocabulary; re-exported here because, like the deadline, it is a wire
#: convention peers must agree on.
from p2p_llm_tunnel_tpu_torch.utils.tracing import (  # noqa: E402
    TRACE_HEADER,  # noqa: F401  (re-exported: the wire-contract surface)
)


def iter_body_chunks(data: bytes, chunk_size: int = MAX_BODY_CHUNK):
    """Split a body into frame-sized chunks. Yields nothing for empty bodies."""
    for i in range(0, len(data), chunk_size):
        yield data[i : i + chunk_size]


def encode_body_frames(
    msg_type: MessageType, stream_id: int, data: bytes,
    chunk_size: int = MAX_BODY_CHUNK,
) -> List[bytes]:
    """Chunk + encode a body into ready-to-send frames in one step.

    Uses the native C++ codec (protocol/native.py) when built — this is the
    per-token hot path on the serve side — falling back to the Python codec.
    """
    from p2p_llm_tunnel_tpu_torch.protocol import native

    frames = native.chunk_body(int(msg_type), stream_id, data, chunk_size)
    if frames is not None:
        return frames
    return [
        TunnelMessage(msg_type, stream_id, c).encode()
        for c in iter_body_chunks(data, chunk_size)
    ]
