"""Mid-stream continuity: replay journal + detached-stream registry.

The fabric's failover contract had one deliberate hole: a request already
streaming when its tunnel link died got a typed ``peer_lost`` truncation —
the tokens the engine kept generating were thrown away and the client
re-prefilled from scratch.  This module closes it on the serve side:

- :class:`ReplayJournal` — a bounded per-stream byte buffer of response
  body bytes already handed to (or awaiting) the tunnel.  Bytes are
  retained until the proxy's FLOW grants acknowledge the client consumed
  them (or until the cap trims them), so a reattaching proxy can ask for
  the stream spliced at exactly its delivered-byte offset.

- :class:`StreamRelay` — the single writer of one resumable stream's
  frames.  The backend/handler appends into the journal; the relay's pump
  task streams journal bytes to the CURRENT attachment (channel, stream
  id, flow window).  When the channel dies the relay detaches: the engine
  generation is NOT cancelled — the journal keeps filling (blocking the
  backend drain at the cap: the journal cap is the backpressure provider)
  for a grace window, and only when the window expires is the stream
  failed, which cancels the generation through the handler's normal
  teardown.

- :class:`DetachedStreams` — the process-global registry a NEW serve
  session (fresh channel after a re-dial) uses to honor a RES_RESUME:
  lookup by token, splice validation, FLOW-ack routing, and the
  ``serve_streams_detached`` / ``serve_replay_buffer_bytes`` accounting.

The registry is process-global like ``utils.metrics.global_metrics``
because detach/reattach straddles serve SESSIONS: the stream outlives the
channel that carried it.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Dict, List, Optional, Set, Tuple

from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    MAX_BODY_CHUNK,
    MessageType,
    ResumeFrame,
    TunnelMessage,
    encode_body_frames,
)
from p2p_llm_tunnel_tpu_torch.transport.base import ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics
from p2p_llm_tunnel_tpu_torch.utils.tracing import global_tracer

log = get_logger(__name__)

#: Default grace window (seconds) a detached stream parks awaiting a
#: RES_RESUME before its engine generation is cancelled (``serve
#: --stream-grace-s``).  Sized to cover a fabric re-dial / breaker
#: half-open probe: signaling rejoin + handshake land well inside it.
DEFAULT_GRACE_S = 5.0
#: Default per-stream replay-journal cap in bytes (``serve
#: --stream-journal-bytes``).  Must comfortably exceed INITIAL_CREDIT
#: (256 KiB): the proxy's delivered offset can lag the serve side's sent
#: offset by up to one full credit window, and a resume whose offset was
#: trimmed from the journal falls back to the typed ``peer_lost`` path.
DEFAULT_JOURNAL_BYTES = 512 * 1024


class ResumeConfig:
    """The serve endpoint's mid-stream-continuity knobs (cli flags
    ``--stream-grace-s`` / ``--stream-journal-bytes``).  ``grace_s <= 0``
    disables resume entirely: no token is minted, RES_HEADERS stays
    byte-identical to the reference, and a mid-stream link death is
    today's typed ``peer_lost`` truncation."""

    __slots__ = ("grace_s", "journal_bytes")

    def __init__(self, grace_s: float = DEFAULT_GRACE_S,
                 journal_bytes: int = DEFAULT_JOURNAL_BYTES):
        self.grace_s = float(grace_s)
        self.journal_bytes = int(journal_bytes)

    @property
    def enabled(self) -> bool:
        return self.grace_s > 0 and self.journal_bytes > 0


class ResumeExpired(Exception):
    """The grace window expired (or the relay was torn down) with the
    stream still detached — the stream is dead and its generation must be
    cancelled.  The failure mode is exactly today's ``peer_lost``: the
    proxy's own grace timer has already fired the typed terminal event."""


class ReplayJournal:
    """Bounded byte buffer of one stream's response body.

    Offsets are ABSOLUTE body-byte positions; ``base`` is the offset of
    ``buf[0]`` (bytes below it were acked and trimmed).  ``meter`` (the
    registry's byte accountant) observes every size change so the
    ``serve_replay_buffer_bytes`` gauge tracks total resident bytes
    without rescanning streams.
    """

    __slots__ = ("base", "buf", "closed", "_meter")

    def __init__(self, meter=None):
        self.base = 0
        self.buf = bytearray()
        self.closed = False
        self._meter = meter

    @property
    def end(self) -> int:
        return self.base + len(self.buf)

    @property
    def size(self) -> int:
        return len(self.buf)

    def append(self, data: bytes) -> None:
        self.buf.extend(data)
        if self._meter is not None:
            self._meter(len(data))

    def trim_to(self, offset: int) -> None:
        """Drop retained bytes below ``offset`` (they were acked)."""
        n = min(max(0, offset - self.base), len(self.buf))
        if n:
            del self.buf[:n]
            self.base += n
            if self._meter is not None:
                self._meter(-n)

    def truncate_to(self, offset: int) -> None:
        """Drop bytes at/after ``offset`` (a deadline cut: the stream is
        being truncated NOW; unsent tail bytes must not flush later)."""
        keep = max(0, offset - self.base)
        n = len(self.buf) - keep
        if n > 0:
            del self.buf[keep:]
            if self._meter is not None:
                self._meter(-n)

    def covers(self, offset: int) -> bool:
        """Can a resume splice at ``offset``? (Not trimmed, not beyond.)"""
        return self.base <= offset <= self.end

    def slice_from(self, offset: int, limit: int = MAX_BODY_CHUNK) -> bytes:
        i = offset - self.base
        return bytes(self.buf[i:i + limit])


class _Attachment:
    """One (channel, stream id, flow window) binding of a relay."""

    __slots__ = ("channel", "stream_id", "flow")

    def __init__(self, channel, stream_id: int, flow):
        self.channel = channel
        self.stream_id = stream_id
        self.flow = flow


class StreamRelay:
    """Single writer of one resumable stream's tunnel frames.

    Handler side: :meth:`write` appends body bytes (blocking at the
    journal cap — the named backpressure provider), :meth:`close` /
    :meth:`cut` record the terminal outcome, :meth:`wait_done` awaits the
    flush.  Channel side: the pump task owns EVERY send, so a reattach
    can splice journal bytes with no interleaving hazard.
    """

    def __init__(self, journal_cap: int, grace_s: float,
                 registry: "DetachedStreams",
                 trace_id: str = "", parent_span: Optional[str] = None):
        self.token = "rs-" + os.urandom(8).hex()
        self.cap = int(journal_cap)
        self.grace_s = float(grace_s)
        self.registry = registry
        self.journal = ReplayJournal(meter=registry.meter)
        self.epoch = 0
        self.sent = 0   # absolute bytes handed to a channel
        self.acked = 0  # absolute bytes the proxy's client consumed
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.handler_task: Optional[asyncio.Task] = None
        self._att: Optional[_Attachment] = None
        self._announce = False  # next pump step must send RES_RESUMED
        self._terminal: Optional[Tuple[Optional[str], str]] = None
        self._detach_deadline = 0.0
        self._detached_at: Optional[float] = None
        self._ok = False
        self._finished = False
        self._failed: Optional[BaseException] = None
        self._kick = asyncio.Event()   # pump wake: data/close/attach
        self._space = asyncio.Event()  # writer wake: journal room freed
        self._space.set()
        self._done = asyncio.Event()
        self._pump_task: Optional[asyncio.Task] = None

    # -- lifecycle --------------------------------------------------------

    @property
    def detached(self) -> bool:
        return self._att is None and not self._finished \
            and self._failed is None

    @property
    def live(self) -> bool:
        return not self._finished and self._failed is None

    def start(self, channel, stream_id: int, flow) -> None:
        """Bind the original attachment and spawn the pump.  Called by the
        handler AFTER RES_HEADERS went out on ``channel``."""
        self._att = _Attachment(channel, stream_id, flow)
        self.handler_task = asyncio.current_task()
        self.registry.register(self)
        self._pump_task = asyncio.create_task(self._pump())

    async def write(self, data: bytes) -> None:
        """Append body bytes, blocking while the journal is at its cap —
        the TC10-named backpressure provider for this stream: a detached
        (or credit-starved) stream stops draining its backend here."""
        if self._failed is not None:
            raise self._failed
        if not data:
            return
        while True:
            self.journal.trim_to(min(self.acked, self.sent))
            if self.journal.size == 0 \
                    or self.journal.size + len(data) <= self.cap:
                break
            # The replay prefix (bytes already SENT, awaiting FLOW acks —
            # which arrive in CREDIT_BATCH lumps, or never for a short
            # stream) yields to backlog before anything blocks: retention
            # is best-effort — a resume below the trim point falls back
            # to the typed peer_lost path — but the cap is a hard memory
            # bound either way, and blocking on unackable sent bytes
            # would deadlock a sub-CREDIT_BATCH stream.
            overflow = self.journal.size + len(data) - self.cap
            trimmable = self.sent - self.journal.base
            if overflow > 0 and trimmable > 0:
                self.journal.trim_to(
                    self.journal.base + min(trimmable, overflow)
                )
                continue
            # Only UNSENT backlog remains: wait for the pump (or a
            # reattach / grace expiry) to free room — the journal cap is
            # this stream's backpressure provider.
            self._space.clear()
            await self._space.wait()
            if self._failed is not None:
                raise self._failed
        self.journal.append(data)
        self._kick.set()

    def close(self, error: "Optional[Tuple[Optional[str], str]]" = None) -> None:
        """The backend finished (``error=None``) or died mid-stream
        (``(code|None, message)`` — the typed/plain ERROR frame to emit
        before RES_END)."""
        self.journal.closed = True
        self._terminal = error
        self._kick.set()

    def cut(self, code: str, message: str) -> None:
        """Deadline truncation: drop UNSENT journal bytes and terminate
        with a typed frame now — the budget is spent, flushing a parked
        tail later would violate it."""
        self.journal.truncate_to(max(self.sent, self.journal.base))
        att = self._att
        if att is not None:
            # Wake a credit-blocked pump: the terminal error + RES_END
            # ride credit-free, exactly like the legacy path's typed
            # frame after a bounded flow debit timed out.
            att.flow.close(att.stream_id)
        self.close((code, message))

    async def wait_done(self) -> bool:
        """Await the pump's flush; True iff RES_END reached a live
        channel with no error frame.  Raises :class:`ResumeExpired` when
        the stream died parked."""
        await self._done.wait()
        if self._failed is not None:
            raise self._failed
        return self._ok

    # -- channel-side transitions ----------------------------------------

    def detach(self, att: Optional[_Attachment] = None) -> None:
        """The current attachment's channel is dead: park the stream for
        the grace window.  Idempotent per attachment."""
        att = att if att is not None else self._att
        if att is None or self._att is not att or not self.live:
            return
        self._att = None
        self._announce = False
        self._detach_deadline = time.monotonic() + self.grace_s
        self._detached_at = time.monotonic()
        att.flow.close(att.stream_id)
        self.registry.on_detach(self, att)
        if self.trace_id and global_tracer.on(self.trace_id):
            global_tracer.add_event(
                "serve.stream_detach", trace_id=self.trace_id,
                parent_id=self.parent_span, track="serve",
                attrs={"token": self.token, "sent": self.sent,
                       "grace_s": self.grace_s},
            )
        log.warning(
            "stream %s detached mid-flight at byte %d; parking %.1fs for "
            "resume (journal %d bytes)",
            self.token, self.sent, self.grace_s, self.journal.size,
        )
        self._kick.set()

    def attach(self, channel, stream_id: int, flow,
               offset: int, epoch: int) -> Tuple[bool, str]:
        """Honor a RES_RESUME: splice the journal at ``offset`` onto a new
        attachment.  Returns (ok, reason); on ok the pump announces
        RES_RESUMED (carrying the incremented epoch) then streams the
        tail."""
        if not self.live:
            return False, "stream already finished"
        if epoch != self.epoch:
            return False, f"stale stream epoch {epoch} (now {self.epoch})"
        if not self.journal.covers(offset):
            return False, (
                f"offset {offset} outside replay journal "
                f"[{self.journal.base}, {self.journal.end}]"
            )
        if self._att is not None:
            # The proxy noticed the link death before this serve session
            # did — supersede the stale attachment.
            self.detach(self._att)
        self.acked = max(self.acked, offset)
        self.sent = offset
        self.journal.trim_to(min(self.acked, self.sent))
        self.epoch += 1
        self._att = _Attachment(channel, stream_id, flow)
        self._announce = True
        self._detached_at = None
        self.registry.on_resume(self)
        if self.trace_id and global_tracer.on(self.trace_id):
            global_tracer.add_event(
                "serve.stream_resume", trace_id=self.trace_id,
                parent_id=self.parent_span, track="serve",
                attrs={"token": self.token, "offset": offset,
                       "epoch": self.epoch},
            )
        log.info("stream %s resumed at byte %d (epoch %d)",
                 self.token, offset, self.epoch)
        self._space.set()
        self._kick.set()
        return True, ""

    def on_ack(self, credit: int) -> None:
        """A FLOW grant arrived: the proxy's client consumed ``credit``
        more bytes — the replay prefix below that watermark may trim."""
        self.acked = min(self.acked + max(0, int(credit)), self.sent)
        self.journal.trim_to(min(self.acked, self.sent))
        self._space.set()

    # -- pump -------------------------------------------------------------

    async def _pump(self) -> None:
        try:
            while True:
                att = self._att
                if att is None:
                    remaining = self._detach_deadline - time.monotonic()
                    if remaining <= 0:
                        raise ResumeExpired(
                            f"stream {self.token} grace window "
                            f"({self.grace_s:.1f}s) expired while detached"
                        )
                    self._kick.clear()
                    if self._att is not None:
                        continue
                    try:
                        await asyncio.wait_for(self._kick.wait(), remaining)
                    except asyncio.TimeoutError:
                        pass
                    continue
                try:
                    if self._announce:
                        self._announce = False
                        await att.channel.send(TunnelMessage.res_resumed(
                            ResumeFrame(att.stream_id, self.token,
                                        self.sent, self.epoch)
                        ).encode())
                        continue
                    if self.sent < self.journal.end:
                        chunk = self.journal.slice_from(self.sent)
                        await att.flow.consume(att.stream_id, len(chunk))
                        if self._att is not att:
                            continue  # detached while credit-blocked
                        for frame in encode_body_frames(
                                MessageType.RES_BODY, att.stream_id, chunk):
                            await att.channel.send(frame)
                        if self._att is not att:
                            # Superseded mid-send (a reattach rewound
                            # `sent` to the proxy's delivered offset while
                            # we were suspended): advancing it now would
                            # corrupt the splice point.
                            continue
                        self.sent += len(chunk)  # tunnelcheck: disable=TC13  guarded RMW: the only concurrent writer of `sent` is attach(), which also replaces self._att — the is-not re-check directly above runs after every suspension, so a superseded pump never advances a rewound offset
                        self._space.set()
                        continue
                    if self.journal.closed:
                        term = self._terminal
                        if term is not None:
                            code, msg = term
                            frame = (
                                TunnelMessage.error(att.stream_id, msg)
                                if code is None else
                                TunnelMessage.typed_error(
                                    att.stream_id, code, msg)
                            )
                            await att.channel.send(frame.encode())
                        await att.channel.send(
                            TunnelMessage.res_end(att.stream_id).encode()
                        )
                        self._finish(ok=term is None, att=att)
                        return
                    self._kick.clear()
                    if (self.sent < self.journal.end or self.journal.closed
                            or self._att is not att):
                        continue
                    await self._kick.wait()
                except ChannelClosed:
                    self.detach(att)
        except ResumeExpired as e:
            log.warning("%s — cancelling its engine generation", e)
            self._fail(e)
        except asyncio.CancelledError:
            self._fail(ResumeExpired(f"stream {self.token} relay cancelled"))
            raise
        except Exception as e:  # never leak the stream on a pump bug
            log.exception("stream relay %s failed", self.token)
            self._fail(ResumeExpired(f"stream relay error: {e}"))
        finally:
            self.registry.release(self)

    def _finish(self, ok: bool, att: Optional[_Attachment] = None) -> None:
        self._ok = ok
        self._finished = True
        if att is not None:
            att.flow.close(att.stream_id)
        self._att = None
        self._done.set()
        self._space.set()

    def _fail(self, exc: BaseException) -> None:
        if self._finished or self._failed is not None:
            return
        self._failed = exc
        att, self._att = self._att, None
        if att is not None:
            att.flow.close(att.stream_id)
        self._done.set()
        self._space.set()


class DetachedStreams:
    """Process-global registry of live resumable streams.

    Named for its purpose: this is the detached-stream registry a
    RES_RESUME consults — every resumable stream registers at birth
    (the proxy may notice a link death before this process does, so the
    token must resolve even while the serve session still believes the
    stream is attached).  The ``serve_streams_detached`` gauge counts
    only the parked ones.
    """

    def __init__(self):
        self._detached: Dict[str, StreamRelay] = {}
        self._by_attachment: Dict[int, Dict[int, StreamRelay]] = {}
        self._bytes = 0

    # -- byte accounting (ReplayJournal meter) ----------------------------

    def meter(self, delta: int) -> None:
        self._bytes += delta
        global_metrics.set_gauge("serve_replay_buffer_bytes",
                                 max(0, self._bytes))

    # -- membership -------------------------------------------------------

    def register(self, relay: StreamRelay) -> None:
        self._sweep()
        self._detached[relay.token] = relay  # tunnelcheck: disable=TC15  released by StreamRelay._pump finally (registry.release) on every exit path incl. grace expiry — the waiver IS the ownership contract
        att = relay._att
        if att is not None:
            self._index(att, relay)
        self._publish()

    def release(self, relay: StreamRelay) -> None:
        self._detached.pop(relay.token, None)
        self._deindex(relay)
        # Whatever the journal still holds is no longer replayable memory.
        relay.journal.trim_to(relay.journal.end)
        self._publish()

    def get(self, token: str) -> Optional[StreamRelay]:
        relay = self._detached.get(token)
        return relay if relay is not None and relay.live else None

    def _index(self, att: _Attachment, relay: StreamRelay) -> None:
        self._by_attachment.setdefault(
            id(att.channel), {}
        )[att.stream_id] = relay

    def _deindex(self, relay: StreamRelay) -> None:
        for cid in [
            cid for cid, sids in self._by_attachment.items()
            if any(r is relay for r in sids.values())
        ]:
            sids = self._by_attachment[cid]
            for sid in [s for s, r in sids.items() if r is relay]:
                del sids[sid]
            if not sids:
                del self._by_attachment[cid]

    # -- transitions ------------------------------------------------------

    def on_detach(self, relay: StreamRelay, att: _Attachment) -> None:
        self._deindex(relay)
        self._publish()

    def on_resume(self, relay: StreamRelay) -> None:
        att = relay._att
        if att is not None:
            self._index(att, relay)
        global_metrics.inc("serve_stream_resumes_total")
        self._publish()

    def on_flow(self, channel, stream_id: int, credit: int) -> None:
        """Route a FLOW grant's ack watermark to the attached relay."""
        relay = self._by_attachment.get(id(channel), {}).get(stream_id)
        if relay is not None:
            relay.on_ack(credit)

    def detach_channel(self, channel) -> "Set[asyncio.Task]":
        """A serve session's channel is dying: park every stream attached
        to it and return the handler tasks the session must NOT cancel —
        parked streams now belong to this registry (and to their grace
        windows), not to the dying session."""
        for relay in list(self._by_attachment.get(id(channel), {}).values()):
            relay.detach()
        return {
            r.handler_task for r in self._detached.values()
            if r.live and r.handler_task is not None
        }

    def detach_attachment(self, channel, stream_id: int) -> bool:
        """The proxy explicitly cancelled ONE resumed attachment (a typed
        ERROR frame on its stream id — e.g. it abandoned the resume probe
        after accepting elsewhere, or gave up inside its grace window):
        park the stream again instead of letting the relay pump feed a
        stream id nobody is demuxing — which would wedge at flow-credit
        exhaustion forever."""
        relay = self._by_attachment.get(id(channel), {}).get(stream_id)
        if relay is None:
            return False
        relay.detach()
        return True

    # -- observability ----------------------------------------------------

    def count_detached(self) -> int:
        return sum(1 for r in self._detached.values() if r.detached)

    def live_count(self) -> int:
        self._sweep()  # zombie relays (dead event loops) must not count
        return sum(1 for r in self._detached.values() if r.live)

    def detached_tokens(self) -> List[str]:
        return sorted(r.token for r in self._detached.values() if r.detached)

    def live_tokens(self) -> List[str]:
        """Every unfinished resumable stream — parked in a grace window
        OR reattached and still flushing (a drain that abandons either
        must name it)."""
        return sorted(r.token for r in self._detached.values() if r.live)

    def _session_relays(self, channel) -> List[StreamRelay]:
        """The relays ONE serve session's drain is responsible for:
        streams attached to ITS channel plus every detached (unowned)
        stream.  Streams healthily attached to a DIFFERENT session's
        channel are that session's business — a multi-session process
        must not have one peer's drain block on (or name) another peer's
        live traffic."""
        mine = self._by_attachment.get(id(channel), {})
        return [
            r for r in self._detached.values()
            if r.live and (r.detached or any(x is r for x in mine.values()))
        ]

    def live_count_for(self, channel) -> int:
        self._sweep()
        return len(self._session_relays(channel))

    def live_tokens_for(self, channel) -> List[str]:
        return sorted(r.token for r in self._session_relays(channel))

    def replay_bytes(self) -> int:
        return max(0, self._bytes)

    def _publish(self) -> None:
        global_metrics.set_gauge("serve_streams_detached",
                                 self.count_detached())
        global_metrics.set_gauge("serve_replay_buffer_bytes",
                                 max(0, self._bytes))

    def _sweep(self) -> None:
        """Drop zombies: a relay whose event loop died (tests run many
        loops per process) never runs its pump finally — anything parked
        way past its grace window is dead weight, not a resumable
        stream."""
        now = time.monotonic()
        for token, relay in list(self._detached.items()):
            if relay.detached and relay._detach_deadline and \
                    now - relay._detach_deadline > 2 * max(relay.grace_s, 1.0):
                self.release(relay)


#: THE registry — process-global because detach/reattach straddles serve
#: sessions (the stream outlives the channel that carried it), exactly
#: like global_metrics straddles them.
global_streams = DetachedStreams()
