"""Serve (provider) endpoint: tunnel frames in → upstream → streamed frames out.

Reference behavior being matched (tunnel/src/serve.rs):
- wait for channel, receive HELLO (≤300 s, serve.rs:37-43), reply AGREE
- keepalive ping every 10 s (serve.rs:68-80); answer PING with PONG (:140-148)
- reassemble per-stream requests, dispatch one task per request (:112-139)
- strip hop-by-hop request headers host/connection/transfer-encoding (:207-212)
- advertise-prefix path rewrite (:167-185)
- 502 with a text body on upstream failure (:221-241)
- stream response chunks as they arrive, sub-chunked to MAX_BODY_CHUNK (:263-277)
- ERROR frame on mid-stream upstream failure, then RES_END (:278-290)

The upstream is pluggable: the default backend forwards over HTTP like the
reference's reqwest hop (serve.rs:219); the TPU engine registers an in-process
backend instead (engine/api.py) — that swap is this project's whole point.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.resume import (
    ResumeConfig,
    ResumeExpired,
    StreamRelay,
    global_streams,
)
from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    DEADLINE_HEADER,  # noqa: F401  (re-exported: the serve-side surface)
    ERROR_CODE_HEADER,
    ERROR_CODES,
    INITIAL_CREDIT,
    KV_EXPORT_HEADER,
    MAX_BODY_CHUNK,
    Agree,
    Hello,
    KvPagesManifest,
    MessageType,
    ProtocolError,
    RequestHeaders,
    ResponseHeaders,
    ResumeFrame,
    TunnelMessage,
    encode_body_frames,
    parse_deadline_ms,
)
from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.flight import global_blackbox, global_flight
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import (
    Metrics,
    derived_retry_after_s,
    global_metrics,
)
from p2p_llm_tunnel_tpu_torch.utils.slo import global_slo
from p2p_llm_tunnel_tpu_torch.utils.tracing import (
    TRACE_HEADER,
    global_tracer,
    new_span_id,
    parse_trace_context,
)

log = get_logger(__name__)

HANDSHAKE_TIMEOUT = 300.0  # serve.rs:37-43
PING_INTERVAL = 10.0  # serve.rs:70

#: Backend contract: (request, body) -> (status, headers, async chunk iterator).
#: Raising before returning headers → 502; raising mid-iteration → ERROR frame.
Backend = Callable[
    [RequestHeaders, bytes],
    Awaitable[Tuple[int, Dict[str, str], AsyncIterator[bytes]]],
]

_HOP_BY_HOP = {"host", "connection", "transfer-encoding"}


class FlowControl:
    """Per-stream response-body credit (the negotiated "flow" feature).

    The serve side starts each stream with INITIAL_CREDIT bytes and blocks
    body emission when exhausted; the proxy replenishes with FLOW frames as
    its HTTP client consumes.  Bounds serve→proxy buffering — the
    backpressure the reference lacks entirely (SURVEY.md §7 hard-part #3:
    a TPU engine at 1800+ tok/s into a slow WAN client would otherwise
    buffer without limit).  Disabled (no-op) unless both peers negotiated
    the feature.
    """

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._streams: Dict[int, list] = {}  # sid → [credit, wake-event]

    def open(self, stream_id: int) -> None:
        if self.enabled:
            self._streams[stream_id] = [INITIAL_CREDIT, asyncio.Event()]

    def close(self, stream_id: int) -> None:
        entry = self._streams.pop(stream_id, None)
        if entry is not None:
            entry[1].set()  # release any blocked sender

    def grant(self, stream_id: int, credit: int) -> None:
        entry = self._streams.get(stream_id)
        if entry is not None:
            entry[0] += credit
            entry[1].set()

    async def consume(self, stream_id: int, n: int) -> None:
        """Debit ``n`` bytes, waiting while the stream is out of credit."""
        if not self.enabled:
            return
        entry = self._streams.get(stream_id)
        if entry is None:
            return
        while entry[0] <= 0 and stream_id in self._streams:
            entry[1].clear()
            await entry[1].wait()
        entry[0] -= n


def build_upstream_url(upstream_base: str, advertise_prefix: str, request_path: str) -> str:
    """Rewrite a tunneled request path for the upstream.

    Matches the reference matrix exactly (serve.rs:167-185 and its 7 tests):
    prefix "/" or "" → pass-through; otherwise strip the prefix, an exact
    match becomes "/", and non-matching paths pass through unchanged.
    """
    base = upstream_base.rstrip("/")
    prefix = advertise_prefix.rstrip("/")
    if prefix in ("", "/"):
        return base + request_path
    if request_path.startswith(prefix):
        stripped = request_path[len(prefix):] or "/"
        return base + stripped
    return base + request_path


def http_backend(upstream_url: str, advertise_prefix: str = "/") -> Backend:
    """The reference-equivalent backend: forward over HTTP, stream the body."""

    async def backend(req: RequestHeaders, body: bytes):
        url = build_upstream_url(upstream_url, advertise_prefix, req.path)
        headers = {k: v for k, v in req.headers.items() if k.lower() not in _HOP_BY_HOP}
        resp = await http11.http_request(req.method, url, headers, body)
        return resp.status, resp.headers, resp.iter_chunks()

    return backend


async def _coalesce(
    chunks: AsyncIterator[bytes], max_bytes: int = MAX_BODY_CHUNK
) -> AsyncIterator[bytes]:
    """Merge backlogged body chunks into fewer, larger frame payloads.

    A pump task drains the backend iterator into a queue at its own pace;
    each yield hands over EVERYTHING currently queued (capped at
    ``max_bytes``, the single-frame payload limit).  When the consumer
    (frame encode → tunnel send → flow-control debit) keeps up, chunks pass
    through 1:1 with no added latency — the first chunk of a stream is
    yielded the moment it arrives, so TTFT is unaffected.  When the producer
    runs ahead (a TPU decode burst lands 512 tokens at once while the
    per-frame path does its asyncio hops), the backlog rides ONE frame
    instead of one-per-token.  Chunk *contents* are untouched: an SSE
    consumer sees the same byte stream and the same event count.

    The reference has no analog — its per-chunk costs sit in SCTP inside
    the webrtc crate (serve.rs:263-277 forwards chunks 1:1); here the
    per-frame cost is Python asyncio, which at 1800+ tok/s × 32 streams is
    material (PERF.md).
    """
    queue: asyncio.Queue = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded in BYTES by the max_buffer window below: the pump pauses at ~4 frames' worth and the consumer reopens the window as it drains (put_nowait must stay infallible for the terminator)
    _done = object()
    # Byte-bounded buffer: the pump must NOT outrun the consumer without
    # limit, or it would defeat the flow-control backpressure the direct
    # `async for` used to provide (a stalled WAN client on an ignore_eos
    # stream would otherwise buffer the whole generation in this queue).
    # The pump pauses while more than ~4 frames' worth is in flight; the
    # consumer reopens the window as it drains.
    max_buffer = 4 * max_bytes
    buffered = 0
    space = asyncio.Event()
    space.set()

    async def pump() -> None:
        nonlocal buffered
        try:
            async for c in chunks:
                while buffered >= max_buffer:
                    space.clear()
                    await space.wait()
                buffered += len(c)
                queue.put_nowait(c)
        except Exception as e:  # propagate mid-stream backend failures
            queue.put_nowait(e)
        finally:
            # Unconditional terminator — also on CancelledError and other
            # BaseExceptions, so the consumer can never block forever on a
            # dead pump (the queue is unbounded, put_nowait cannot fail).
            queue.put_nowait(_done)

    def _consumed(c: bytes) -> None:
        nonlocal buffered
        buffered -= len(c)
        if buffered < max_buffer:
            space.set()

    task = asyncio.create_task(pump())
    try:
        while True:
            item = await queue.get()
            if item is _done:
                return
            if isinstance(item, Exception):
                raise item
            _consumed(item)
            buf = [item]
            size = len(item)
            while size < max_bytes and not queue.empty():
                nxt = queue.get_nowait()
                if nxt is _done or isinstance(nxt, Exception):
                    yield b"".join(buf)
                    if nxt is _done:
                        return
                    raise nxt
                _consumed(nxt)
                buf.append(nxt)
                size += len(nxt)
            yield b"".join(buf) if len(buf) > 1 else item
    finally:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass


async def _handle_request(
    channel: Channel, backend: Backend, req: RequestHeaders, body: bytes,
    flow: FlowControl, peer_label: str = "",
    resume_cfg: Optional[ResumeConfig] = None,
) -> None:
    t0 = time.monotonic()
    ctx = parse_trace_context(req.headers)
    span = None
    if ctx is not None and global_tracer.on(ctx.trace_id):
        # This dispatch gets its own span, and the header the BACKEND sees
        # is rewritten to parent under it — so the engine's spans chain
        # proxy.request -> serve.dispatch -> engine.request under one
        # propagated trace id.
        span = new_span_id()
        req.headers = dict(req.headers)
        req.headers[TRACE_HEADER] = f"{ctx.trace_id}/{span}"
    try:
        flow.open(req.stream_id)
        await _handle_request_inner(channel, backend, req, body, flow,
                                    resume_cfg)
    except ChannelClosed:
        # Tunnel died while responding; the serve loop notices separately.
        log.debug("channel closed while responding to stream %d", req.stream_id)
    finally:
        flow.close(req.stream_id)
        if span is not None:
            attrs: Dict[str, object] = {
                "stream_id": req.stream_id, "path": req.path,
            }
            if peer_label:
                # The fabric identity this serve peer learned at handshake
                # (Hello.peer): the stitched fleet trace assigns this span
                # — and, via parent linkage, the engine spans under it —
                # to the right per-peer process lane, so a failover shows
                # sibling serve.dispatch spans on two lanes.
                attrs["peer"] = peer_label
            global_tracer.add_span(
                "serve.dispatch", trace_id=ctx.trace_id, span_id=span,
                parent_id=ctx.span_id or None, track="serve", t0=t0,
                attrs=attrs,
            )


async def _handle_request_inner(
    channel: Channel, backend: Backend, req: RequestHeaders, body: bytes,
    flow: FlowControl, resume_cfg: Optional[ResumeConfig] = None,
) -> None:
    stream_id = req.stream_id
    global_metrics.inc("serve_requests_total")
    tctx = parse_trace_context(req.headers)  # parent: this dispatch's span

    def trace_timeout(where: str) -> None:
        if tctx is not None:
            global_tracer.add_event(
                "serve.timeout", trace_id=tctx.trace_id,
                parent_id=tctx.span_id or None, track="serve",
                attrs={"stream_id": stream_id, "where": where},
            )

    # Per-request deadline (x-tunnel-deadline-ms): enforced here over the
    # whole backend call + body relay, independently of the engine's own
    # scheduler-side eviction — this layer also covers the HTTP backend
    # and a stalled flow-control/transport path.
    deadline: Optional[float] = None
    dl_ms = parse_deadline_ms(req.headers)
    if dl_ms is not None:
        deadline = time.monotonic() + dl_ms / 1000.0
    try:
        if deadline is not None:
            status, headers, chunks = await asyncio.wait_for(
                backend(req, body), deadline - time.monotonic()
            )
        else:
            status, headers, chunks = await backend(req, body)
    except asyncio.TimeoutError:
        if deadline is None:
            # No client budget was set, so this TimeoutError is the
            # backend's own (e.g. http11's connect/read timeout) — an
            # upstream failure, not a deadline expiry: 502, not 504, and
            # the upstream-errors counter, not the timeouts one.
            log.error("upstream request timed out for stream %d", stream_id)
            global_metrics.inc("serve_upstream_errors_total")
            global_slo.record("availability", False)
            await _send_simple(
                channel, stream_id, 502, b"Bad Gateway: upstream timeout"
            )
            return
        log.warning("stream %d hit its %.0fms deadline before headers",
                    stream_id, dl_ms)
        global_metrics.inc("serve_timeouts_total")
        global_slo.record("availability", False)
        # A request that timed out before ANY response byte never fed the
        # engine's TTFT sample — count it as a bad ttft event here, or the
        # latency objective would have pure survivorship bias: a wedged
        # engine whose every request deadlines out would read ttft-ok
        # exactly when TTFT is at its worst.  (Deadline-less requests that
        # hang are still invisible to this objective — availability and
        # the decode watchdog carry that case.)
        global_slo.record("ttft", False)
        trace_timeout("before-headers")
        await _send_simple(
            channel, stream_id, 504, b"Gateway Timeout: deadline exceeded"
        )
        return
    except Exception as e:
        log.error("upstream request failed for stream %d: %s", stream_id, e)
        global_metrics.inc("serve_upstream_errors_total")
        global_slo.record("availability", False)
        await _send_simple(
            channel, stream_id, 502, f"Bad Gateway: {e}".encode()
        )
        return

    # A backend error response may carry a typed tunnel-error code in a
    # reserved header (e.g. the engine API's 429 busy/tenant_overlimit):
    # pop it before relaying and follow RES_END with the matching typed
    # ERROR frame, so protocol-aware peers dispatch on the same vocabulary
    # regardless of which layer shed the request.  Sent after RES_END —
    # the proxy forgets the stream there, so HTTP clients are unaffected.
    shed_code = None
    for k in list(headers):
        if k.lower() == ERROR_CODE_HEADER:
            v = headers.pop(k)
            if v in ERROR_CODES:
                shed_code = v
            else:
                log.warning("backend sent unknown %s %r; dropping",
                            ERROR_CODE_HEADER, v)
    # Mid-stream continuity: token-stream responses (SSE and
    # NDJSON — the two streaming vocabularies) get a resume token in the
    # RES_HEADERS extension and their frames routed through a StreamRelay
    # whose replay journal lets a reattaching proxy splice the stream at
    # its delivered-byte offset after a tunnel reset.  Everything else
    # keeps the exact legacy frame path (wire byte-identical).
    ctype = ""
    for k, v in headers.items():
        if k.lower() == "content-type":
            ctype = v.lower()
    relay: Optional[StreamRelay] = None
    rh = ResponseHeaders(stream_id, status, headers)
    if (resume_cfg is not None and resume_cfg.enabled and status == 200
            and shed_code is None
            and ("text/event-stream" in ctype or "ndjson" in ctype)):
        relay = StreamRelay(
            resume_cfg.journal_bytes, resume_cfg.grace_s, global_streams,
            trace_id=tctx.trace_id if tctx is not None else "",
            parent_span=(tctx.span_id or None) if tctx is not None else None,
        )
        rh.resume = relay.token
        rh.grace = resume_cfg.grace_s
    await channel.send(TunnelMessage.res_headers(rh).encode())
    if relay is not None:
        relay.start(channel, stream_id, flow)
    agen = _coalesce(chunks)

    async def bounded(awaitable):
        """Await under what remains of the deadline — covers the backend
        iterator AND the flow-control debit, so a credit-starved peer
        cannot pin the stream past its budget either."""
        if deadline is None:
            return await awaitable
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise asyncio.TimeoutError
        return await asyncio.wait_for(awaitable, remaining)

    served_ok = True  # flipped by any mid-stream failure below
    if relay is not None:
        served_ok = await _relay_body(
            relay, agen, bounded, deadline, stream_id, dl_ms, trace_timeout,
        )
        global_slo.record("availability", served_ok and status < 500)
        log.debug("response %d complete: status=%d", stream_id, status)
        return
    try:
        while True:
            try:
                chunk = await bounded(agen.__anext__())
            except StopAsyncIteration:
                break
            await bounded(flow.consume(stream_id, len(chunk)))
            for frame in encode_body_frames(MessageType.RES_BODY, stream_id, chunk):
                await channel.send(frame)
    except asyncio.TimeoutError:
        served_ok = False
        if deadline is None:
            # A backend-internal timeout mid-stream (no client budget set):
            # report it as the upstream failure it is.
            log.error("upstream stream timed out for stream %d", stream_id)
            global_metrics.inc("serve_upstream_errors_total")
            await channel.send(
                TunnelMessage.error(
                    stream_id, "upstream error: timeout"
                ).encode()
            )
        else:
            # Deadline blown mid-stream: truncate with a TYPED error frame
            # so protocol-aware peers can distinguish a timeout from an
            # upstream crash (the reference's ERROR payload is free text).
            log.warning("stream %d hit its %.0fms deadline mid-stream",
                        stream_id, dl_ms)
            global_metrics.inc("serve_timeouts_total")
            trace_timeout("mid-stream")
            await channel.send(
                TunnelMessage.typed_error(
                    stream_id, "timeout", "deadline exceeded"
                ).encode()
            )
    except Exception as e:
        # Upstream dropped mid-stream — truncate with an ERROR frame
        # (serve.rs:278-284); the proxy ends the HTTP body without an error.
        # Exceptions that carry a tunnel_code emit the typed form.  NOTE:
        # the engine API's STREAMING bodies no longer raise typed
        # exceptions here — a mid-stream shed/deadline eviction ends the
        # SSE body in-band (typed finish_reason + [DONE]) instead of
        # truncating a 200; mid-stream timeouts still get their
        # typed frame from the deadline branch above when the client sent
        # x-tunnel-deadline-ms, and engine_deadline_timeouts_total counts
        # every engine-side eviction regardless of which layer noticed.
        served_ok = False
        log.error("upstream stream error for stream %d: %s", stream_id, e)
        code = getattr(e, "tunnel_code", None)
        if code == "timeout":
            global_metrics.inc("serve_timeouts_total")
            trace_timeout("backend")
        if code is not None:
            frame = TunnelMessage.typed_error(stream_id, code, str(e))
        else:
            frame = TunnelMessage.error(stream_id, f"upstream error: {e}")
        await channel.send(frame.encode())
    finally:
        await agen.aclose()
    await channel.send(TunnelMessage.res_end(stream_id).encode())
    if shed_code is not None:
        global_metrics.inc("serve_shed_total")
        await channel.send(TunnelMessage.typed_error(
            stream_id, shed_code, f"shed by backend admission ({status})",
        ).encode())
    # Availability objective: one event per dispatched request —
    # good iff it was relayed without a shed, a server error, or a
    # mid-stream failure.  (A stream an engine displaces AFTER admission
    # ends in-band with a typed finish_reason on a 200 — those count good
    # here; the engine's own shed counters carry that signal.)
    global_slo.record(
        "availability", served_ok and shed_code is None and status < 500
    )
    log.debug("response %d complete: status=%d", stream_id, status)


async def _relay_body(
    relay: StreamRelay, agen, bounded, deadline, stream_id: int,
    dl_ms, trace_timeout,
) -> bool:
    """Drain the backend through a resumable StreamRelay.

    The handler only ever touches the JOURNAL (relay.write blocks at the
    cap — the stream's backpressure); the relay's pump owns every channel
    send, so a mid-stream tunnel reset detaches the stream instead of
    killing it and a later RES_RESUME splices the journal tail with no
    interleaving hazard.  Returns served_ok (RES_END flushed cleanly).
    The typed-error/timeout vocabulary matches the legacy frame path
    exactly — when no resume happens the wire is the same conversation.
    """
    served_ok = True
    try:
        while True:
            try:
                chunk = await bounded(agen.__anext__())
            except StopAsyncIteration:
                break
            await bounded(relay.write(chunk))
        relay.close()
    except asyncio.TimeoutError:
        served_ok = False
        if deadline is None:
            log.error("upstream stream timed out for stream %d", stream_id)
            global_metrics.inc("serve_upstream_errors_total")
            relay.close((None, "upstream error: timeout"))
        else:
            log.warning("stream %d hit its %.0fms deadline mid-stream",
                        stream_id, dl_ms)
            global_metrics.inc("serve_timeouts_total")
            trace_timeout("mid-stream")
            relay.cut("timeout", "deadline exceeded")
    except ResumeExpired:
        # The stream died parked: the proxy's own grace timer has already
        # fired the typed peer_lost terminal toward the client — nothing
        # left to say, just stop generating (agen.aclose below).
        return False
    except Exception as e:
        served_ok = False
        log.error("upstream stream error for stream %d: %s", stream_id, e)
        code = getattr(e, "tunnel_code", None)
        if code == "timeout":
            global_metrics.inc("serve_timeouts_total")
            trace_timeout("backend")
        relay.close((
            code, str(e) if code is not None else f"upstream error: {e}",
        ))
    finally:
        await agen.aclose()
    try:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise asyncio.TimeoutError
            flushed = await asyncio.wait_for(relay.wait_done(), remaining)
        else:
            flushed = await relay.wait_done()
        return served_ok and flushed
    except asyncio.TimeoutError:
        # Deadline hit while the flush was parked or credit-starved:
        # truncate NOW (same contract as the legacy path's bounded flow
        # debit) and let the pump emit the typed frame if a channel is
        # still attached — bounded by the grace window otherwise.
        global_metrics.inc("serve_timeouts_total")
        trace_timeout("mid-stream")
        relay.cut("timeout", "deadline exceeded")
        try:
            await relay.wait_done()
        except ResumeExpired:
            pass
        return False
    except ResumeExpired:
        return False


async def _send_simple(
    channel: Channel, stream_id: int, status: int, body: bytes,
    headers: Optional[Dict[str, str]] = None,
) -> None:
    """One complete small response: headers + body + end.  The body is
    frame-chunked, so loop-served payloads (a /healthz?trace=1 journal can
    exceed one frame) never trip the MAX_FRAME_SIZE cap."""
    h = {"content-type": "text/plain"}
    if headers:
        h.update(headers)
    await channel.send(
        TunnelMessage.res_headers(ResponseHeaders(stream_id, status, h)).encode()
    )
    for frame in encode_body_frames(MessageType.RES_BODY, stream_id, body):
        await channel.send(frame)
    await channel.send(TunnelMessage.res_end(stream_id).encode())


async def _handle_kv_export(
    channel: Channel, req: RequestHeaders, body: bytes, flow: FlowControl,
    kv_export,
) -> None:
    """Prefill-side half of a disaggregated handoff.

    The proxy sent a normal generation request tagged KV_EXPORT_HEADER;
    the backend hook runs admission + prefill for it (one truncated
    generation — every existing scheduling/chunking/mux path untouched)
    and hands back the prompt's resident chain prefix.  The answer rides
    the SAME stream in the KV_PAGES vocabulary: HDR (manifest) + CHUNK*
    (page bytes, flow-controlled like a response body) + END.

    Anything that prevents a useful export — backend refusal, admission
    shed, empty chain, crash — answers a plain ERROR frame instead.  The
    proxy treats any non-KV answer as "dispatch without pages": this
    path can only ever decline the optimization, never fail a request.
    """
    sid = req.stream_id
    try:
        flow.open(sid)
        try:
            export = await kv_export(req, body)
        except Exception as e:  # advisory path: never tear down the link
            log.warning("kv export failed for stream %d: %s", sid, e)
            export = None
        if not export or not export.get("pages"):
            await channel.send(TunnelMessage.error(
                sid, "kv export: no resident pages to ship"
            ).encode())
            return
        manifest = KvPagesManifest(
            sid, meta=dict(export["meta"]), pages=list(export["pages"]),
        )
        await channel.send(TunnelMessage.kv_pages_hdr(manifest).encode())
        blob = b"".join(export["blobs"])
        for off in range(0, len(blob), MAX_BODY_CHUNK):
            chunk = bytes(blob[off:off + MAX_BODY_CHUNK])
            await flow.consume(sid, len(chunk))
            await channel.send(
                TunnelMessage.kv_pages_chunk(sid, chunk).encode()
            )
        await channel.send(TunnelMessage.kv_pages_end(sid).encode())
        log.debug("kv export %d: shipped %d page(s), %d bytes",
                  sid, len(manifest.pages), len(blob))
    except ChannelClosed:
        log.debug("channel closed during kv export for stream %d", sid)
    finally:
        flow.close(sid)


async def _handle_kv_import(
    channel: Channel, stream_id: int, manifest: KvPagesManifest,
    buf: bytes, kv_import,
) -> None:
    """Decode-side half of a disaggregated handoff.

    Splits the accumulated transfer into per-page blobs (manifest order,
    sizes from the manifest — the same accounting the checksums cover)
    and splices them through the engine's two-phase page-in.  A pin
    mismatch answers the TYPED ``page_pin`` refusal — legal here because
    this is a dedicated transfer stream, never a request stream a proxy
    would demux as a request failure.  Success answers KV_PAGES_ACK with
    the spliced count.  Either way the decode peer serves the follow-up
    request normally: with a warm prefix on ACK, with a local re-prefill
    otherwise.
    """
    try:
        blobs = []
        off = 0
        for p in manifest.pages:
            n = int(p["nbytes"])
            blobs.append(bytes(buf[off:off + n]))
            off += n
        if off != len(buf):
            raise ProtocolError(
                f"kv transfer size mismatch: manifest claims {off} "
                f"bytes, received {len(buf)}"
            )
        spliced = await kv_import(manifest.meta, manifest.pages, blobs)
        await channel.send(
            TunnelMessage.kv_pages_ack(stream_id, int(spliced)).encode()
        )
        log.debug("kv import %d: spliced %d page(s)", stream_id, spliced)
    except ChannelClosed:
        log.debug("channel closed during kv import for stream %d", stream_id)
    except Exception as e:
        log.warning("kv import failed for stream %d: %s", stream_id, e)
        code = getattr(e, "tunnel_code", None)
        if code is not None:
            frame = TunnelMessage.typed_error(stream_id, code, str(e))
        else:
            frame = TunnelMessage.error(stream_id, f"kv import failed: {e}")
        try:
            await channel.send(frame.encode())
        except ChannelClosed:
            pass


def _retry_after_s(inflight: int) -> float:
    """Advisory Retry-After for a serve-layer 429, derived from the live
    load instead of a constant: the time to turn over the current
    in-flight set at the recent dispatch rate (shared formula:
    utils.metrics.derived_retry_after_s).  Published as the
    ``serve_retry_after_s`` gauge on every computation."""
    return derived_retry_after_s(
        inflight, "serve_requests_total", "serve_retry_after_s",
    )


async def _send_healthz(
    channel: Channel, stream_id: int, draining: bool, inflight: int,
    peer_label: str = "", disagg: Optional[Dict[str, object]] = None,
) -> None:
    """/healthz: ok|degraded|draining + queue/occupancy from the metrics
    registry (engine gauges; zeros under the plain HTTP backend).  200 only
    when fully healthy, 503 otherwise — the load-balancer convention."""
    # SLO verdicts: a burning/breached objective marks this peer
    # DEGRADED — the same signal a stalled decode watchdog raises — so the
    # fabric's health routing steers new dispatches away from a peer that
    # is consuming its error budget unsustainably, before the objective is
    # lost fleet-wide.  (Inert while the SLO engine is disabled.)
    slo_section = global_slo.section()
    degraded = (global_metrics.gauge("engine_degraded") > 0
                or bool(slo_section["alerting"]))
    state = "draining" if draining else ("degraded" if degraded else "ok")
    # WHY the peer is not-ok: the fabric routes
    # around degraded peers, and without a reason the routing decision is
    # unexplainable from the proxy.  Priority order mirrors the status
    # computation: a drain beats a watchdog trip beats an SLO burn.
    if draining:
        reason = "drain"
    elif global_metrics.gauge("engine_degraded") > 0:
        reason = "watchdog"
    elif slo_section["alerting"]:
        reason = "slo"
    else:
        reason = None
    payload = {
        "status": state,
        "engine_degraded_reason": reason,
        # The fabric identity this peer learned at handshake ("" when
        # joined untagged): lets an operator match a tunneled /healthz
        # answer to the proxy's per-peer fabric snapshot.
        "peer": peer_label or None,
        "slo": slo_section,
        "queue_depth": int(global_metrics.gauge("engine_queue_depth")),
        "slot_occupancy": global_metrics.gauge("engine_batch_occupancy"),
        "inflight_requests": inflight,
        # Observability: the decode program's launch profile and
        # the warmup compile bill — fused-path regressions show up here
        # without a chip window (0 = probe unavailable on this host).
        "decode_kernels_per_step": int(
            global_metrics.gauge("engine_decode_kernels_per_step")
        ),
        "warmup_compile_s": round(
            global_metrics.gauge("engine_warmup_compile_s"), 1
        ),
        # Observability: the TTFT decomposition (queue wait vs
        # prefill execution), the multiplexing controller's current prefill
        # budget, and shared-prefix admission dedup — the numbers that say
        # WHERE time-to-first-token went under load.
        "ttft_split": {
            "queue_wait_p50_ms": round(
                global_metrics.percentile("engine_queue_wait_ms", 50), 1
            ),
            "prefill_exec_p50_ms": round(
                global_metrics.percentile("engine_prefill_exec_ms", 50), 1
            ),
        },
        "mux_budget_tokens": int(
            global_metrics.gauge("engine_mux_budget_tokens")
        ),
        "prefix_dedup_hits": int(
            global_metrics.counter("engine_prefix_dedup_hits_total")
        ),
        # Observability: the fused speculative-decode ledger —
        # lifetime proposed/accepted verify tokens, the windowed (last-64
        # bursts) acceptance rate the adaptive-K controller steers on, and
        # the draft-history registry size (nonzero at rest is a leak;
        # loadgen's post-run gate asserts it).
        "spec": {
            "proposed_total": int(
                global_metrics.counter("engine_spec_proposed_tokens_total")
            ),
            "accepted_total": int(
                global_metrics.counter("engine_spec_accepted_tokens_total")
            ),
            "accept_rate": round(
                global_metrics.gauge("engine_spec_accept_rate"), 3
            ),
            "hist_entries": int(
                global_metrics.gauge("engine_spec_hist_entries")
            ),
        },
        # Observability: tail percentiles the 1k-client ingress
        # item's SLO reporting needs (p99/p999 next to the p50 split),
        # and prefix-pool memory accounting (first slice of the
        # unified-paged-KV item; kv_bytes reflects the kv_quant mode).
        "tails": {
            "ttft_p99_ms": round(
                global_metrics.percentile("engine_ttft_ms", 99), 1
            ),
            "ttft_p999_ms": round(
                global_metrics.percentile("engine_ttft_ms", 99.9), 1
            ),
            "ttfb_p99_ms": round(
                global_metrics.percentile("proxy_ttfb_ms", 99), 1
            ),
            "ttfb_p999_ms": round(
                global_metrics.percentile("proxy_ttfb_ms", 99.9), 1
            ),
        },
        # Observability: the composition-fence registry — every
        # knob the engine auto-disabled at startup, with its reason.  The
        # hero configuration (int4 + kv-int4 + fused + mux + prefix)
        # reports an EMPTY list here; operators verify it fleet-wide via
        # the proxy's federated /healthz view.
        "config": {
            "fences": global_metrics.info("config_fences", []) or [],
        },
        # Observability: the disaggregated prefill/decode ledger —
        # this peer's serving role, pages shipped (prefill side) and
        # spliced from the wire (decode side), and the in-flight transfer
        # count (nonzero at rest is a leak; loadgen's post-run gate
        # asserts it).  null under backends with no engine.
        "disagg": disagg,
        "prefix_pool": {
            "blocks_used": int(
                global_metrics.gauge("engine_prefix_pool_blocks_used")
            ),
            "blocks_free": int(
                global_metrics.gauge("engine_prefix_pool_blocks_free")
            ),
            "kv_bytes": int(
                global_metrics.gauge("engine_prefix_pool_kv_bytes")
            ),
            # admission-time page reservations (nonzero at rest
            # is a leak), cost-aware eviction volume, and the
            # conversation cache's reuse accounting — the multi-turn
            # "turn-N re-prefills only its tail" story in numbers.
            "pages_reserved": int(
                global_metrics.gauge("engine_prefix_pool_pages_reserved")
            ),
            "evictions_total": int(
                global_metrics.counter("engine_prefix_evictions_total")
            ),
            "conversation": {
                "saved_pages_total": int(
                    global_metrics.counter("engine_conv_saved_pages_total")
                ),
                "hits_total": int(
                    global_metrics.counter("engine_conv_hits_total")
                ),
                "hit_tokens_total": int(
                    global_metrics.counter("engine_conv_hit_tokens_total")
                ),
            },
            # the host-RAM spill tier — residency, bytes, the
            # in-flight tier-I/O ledger (nonzero at rest is a leak), the
            # splice/page-out volumes, the dropped-page-in count (each
            # one fell back to tail re-prefill), and why the engine is
            # degraded when it is ("memory" = thrash detector).  Fabric
            # health routing reads degraded_reason to steer around a
            # memory-pressured peer.
            "spill": {
                "pages": int(global_metrics.gauge("engine_spill_pages")),
                "bytes": int(global_metrics.gauge("engine_spill_bytes")),
                "inflight": int(
                    global_metrics.gauge("engine_spill_inflight")
                ),
                "pageouts_total": int(
                    global_metrics.counter("engine_spill_pageouts_total")
                ),
                "pageins_total": int(
                    global_metrics.counter("engine_spill_pageins_total")
                ),
                "pagein_failures_total": int(
                    global_metrics.counter(
                        "engine_spill_pagein_failures_total"
                    )
                ),
                "memory_sheds_total": int(
                    global_metrics.counter("engine_memory_shed_total")
                ),
                "thrash_trips_total": int(
                    global_metrics.counter("engine_thrash_trips_total")
                ),
            },
            "degraded_reason": str(
                global_metrics.info("engine_degraded_reason", "") or ""
            ),
        },
        # Observability: per-tenant ingress accounting (in-flight,
        # token rate, sheds) and the advisory Retry-After the 429 paths
        # are currently quoting — the numbers that say WHO is loading the
        # server and whether fairness is biting.
        # Observability: mid-stream continuity accounting — how
        # many streams are parked in the grace window right now, resident
        # replay-journal bytes (the memory cost of resumability), and how
        # many resumes this process has served.  loadgen's post-run leak
        # check asserts detached == 0 and replay_buffer_bytes == 0.
        "streams": {
            "detached": global_streams.count_detached(),
            "resumable_live": global_streams.live_count(),
            "replay_buffer_bytes": global_streams.replay_bytes(),
            "resumes_total": int(
                global_metrics.counter("serve_stream_resumes_total")
            ),
        },
        "tenants": global_metrics.tenant_snapshot(),
        "retry_after_s": {
            "engine": round(global_metrics.gauge("engine_retry_after_s"), 1),
            "serve": round(global_metrics.gauge("serve_retry_after_s"), 1),
        },
    }
    await _send_simple(
        channel, stream_id, 200 if state == "ok" else 503,
        json.dumps(payload).encode(), {"content-type": "application/json"},
    )


async def run_serve(
    channel: Channel,
    upstream_url: str = "",
    advertise_prefix: str = "/",
    backend: Optional[Backend] = None,
    max_inflight: int = 0,
    drain: Optional[asyncio.Event] = None,
    drain_timeout: float = 0.0,
    stream_grace_s: float = -1.0,
    stream_journal_bytes: int = 0,
) -> None:
    """Run the provider side until the tunnel dies; raises to trigger retry.

    ``max_inflight`` bounds concurrently-dispatched requests (0 = unbounded):
    beyond it, requests get HTTP 429 + Retry-After plus a typed ``busy``
    tunnel-error frame instead of queueing without bound.

    ``drain`` (optional) is the graceful-shutdown switch: once set, no new
    request is admitted (503 ``draining``), in-flight responses run to
    completion, then the channel closes and run_serve RETURNS cleanly
    instead of raising — the supervisor sees a clean exit, not a retry.

    ``drain_timeout`` (> 0) bounds how long a drain waits for in-flight
    streams: past it the still-unfinished streams are abandoned, a
    postmortem bundle captures WHY the drain could not complete (trigger
    ``drain`` — a stream that never finishes during shutdown is exactly
    the wedge an operator needs the black box for), and the channel
    closes anyway.  0 keeps the historical wait-forever behavior.

    ``stream_grace_s`` / ``stream_journal_bytes`` are the mid-stream
    continuity knobs: token streams (SSE/NDJSON) carry a
    resume token, their bytes are journaled (bounded per stream by the
    journal cap), and a stream whose channel dies mid-flight PARKS for
    the grace window — engine generation still running — until a
    RES_RESUME on a fresh channel splices the journal at the proxy's
    delivered offset, or the window expires and the generation is
    cancelled (today's typed ``peer_lost`` outcome, strictly narrowed).
    Defaults: resume.DEFAULT_GRACE_S / DEFAULT_JOURNAL_BYTES;
    ``stream_grace_s=0`` disables resume entirely (legacy wire).
    """
    if backend is None:
        backend = http_backend(upstream_url, advertise_prefix)
    resume_cfg = ResumeConfig(
        grace_s=(stream_grace_s if stream_grace_s >= 0
                 else ResumeConfig().grace_s),
        journal_bytes=(stream_journal_bytes if stream_journal_bytes > 0
                       else ResumeConfig().journal_bytes),
    )

    if not channel.connected.is_set():
        log.info("waiting for channel to be ready...")
        await channel.connected.wait()
    log.info("channel ready, performing handshake...")

    try:
        raw = await asyncio.wait_for(channel.recv(), HANDSHAKE_TIMEOUT)
    except asyncio.TimeoutError:
        raise RuntimeError("handshake timeout: no HELLO received within 5 minutes")
    except ChannelClosed:
        raise RuntimeError("channel closed before handshake")

    hello_msg = TunnelMessage.decode(raw)
    if hello_msg.msg_type != MessageType.HELLO:
        raise RuntimeError(f"expected HELLO, got {hello_msg.msg_type.name}")
    hello = Hello.from_json(hello_msg.payload)
    agree = Agree.from_hello(hello)
    # Role advertisement: a role-split engine stamps its serving
    # role into AGREE so the proxy's PeerSet can route by it — prefill
    # peers take export probes, decode peers take the affinity-routed
    # dispatch.  "both" (the default) is omitted from the wire entirely.
    agree.role = str(getattr(backend, "engine_role", "both") or "both")
    await channel.send(TunnelMessage.agree(agree).encode())
    flow = FlowControl("flow" in agree.features)
    features = frozenset(agree.features)
    # Fabric identity: a fabric proxy stamps the peer id it
    # assigned this link into HELLO; serve-side spans carry it so the
    # stitched fleet trace can attribute them to the right process lane.
    # Empty for classic 2-peer rooms and reference peers (wire unchanged).
    peer_label = hello.peer
    log.info("sent AGREE, tunnel ready (flow control %s%s%s)",
             "on" if flow.enabled else "off",
             f", role {agree.role}" if agree.role != "both" else "",
             f", fabric peer id {peer_label!r}" if peer_label else "")

    pending: Dict[int, Tuple[RequestHeaders, bytearray]] = {}
    kv_pending: Dict[int, Tuple[KvPagesManifest, bytearray]] = {}
    request_tasks: set[asyncio.Task] = set()

    async def keepalive() -> None:
        while True:
            await asyncio.sleep(PING_INTERVAL)
            try:
                await channel.send(TunnelMessage.ping().encode())
            except ChannelClosed:
                return

    ping_task = asyncio.create_task(keepalive())

    async def drainer() -> None:
        """Wait for the drain signal, let in-flight streams finish, then
        close the channel — which pops the recv loop with ChannelClosed
        and turns into a CLEAN return below.  With ``drain_timeout`` set,
        a drain that cannot finish captures a postmortem and closes
        anyway."""
        await drain.wait()
        log.info(
            "drain: stopped admitting; %d request(s) in flight",
            len(request_tasks),
        )
        deadline = (time.monotonic() + drain_timeout
                    if drain_timeout > 0 else None)
        timed_out = False
        while request_tasks:
            timeout = None
            if deadline is not None:
                timeout = max(0.01, deadline - time.monotonic())
            await asyncio.wait(set(request_tasks), timeout=timeout)
            if (request_tasks and deadline is not None
                    and time.monotonic() >= deadline):
                timed_out = True
                break
        # Detached streams are NOT in request_tasks — they
        # belong to the registry and its grace windows.  A drain must
        # either flush them (reattach-and-finish, or grace expiry frees
        # them — both bounded by the grace window) inside the budget, or
        # NAME them in the postmortem attribution: silently extending the
        # drain on a parked stream, or silently vanishing one, are both
        # wrong.  Scoped to THIS session (streams attached to this
        # channel + unowned detached ones): a multi-session process must
        # not have one peer's drain block on another peer's healthy
        # streams.
        while not timed_out and global_streams.live_count_for(channel) > 0:
            if deadline is not None and time.monotonic() >= deadline:
                timed_out = True
                break
            await asyncio.sleep(0.05)
        if timed_out:
            abandoned = global_streams.live_tokens_for(channel)
            attribution = (
                f"{len(request_tasks)} stream(s) unfinished "
                f"after {drain_timeout:.1f}s drain budget"
            )
            if abandoned:
                attribution += (
                    f"; {len(abandoned)} resumable stream(s) abandoned "
                    f"(detached mid-grace or still flushing): "
                    f"{', '.join(abandoned)}"
                )
            log.error(
                "drain timeout: %d stream(s) still unfinished (+%d "
                "detached) after %.1fs; capturing postmortem and closing "
                "anyway", len(request_tasks),
                len(abandoned), drain_timeout,
            )
            global_blackbox.capture("drain", attribution=attribution)
        log.info("drain complete, closing tunnel")
        channel.close()

    drain_task = asyncio.create_task(drainer()) if drain is not None else None
    try:
        while True:
            try:
                raw = await channel.recv()
            except ChannelClosed:
                if drain is not None and drain.is_set():
                    log.info("serve drained cleanly")
                    return
                raise RuntimeError("channel closed, serve ending")

            try:
                msg = TunnelMessage.decode(raw)
            except ProtocolError as e:
                log.warning("failed to decode tunnel message: %s", e)
                continue

            try:
                await _serve_dispatch(
                    channel, backend, flow, pending, request_tasks,
                    max_inflight, drain, msg, peer_label, resume_cfg,
                    features, kv_pending,
                )
            except ChannelClosed:
                # The drainer can close the channel between our recv and a
                # reply send (healthz/shed responses); that window must
                # still count as a clean drain, not a failed attempt.
                if drain is not None and drain.is_set():
                    log.info("serve drained cleanly")
                    return
                raise RuntimeError("channel closed, serve ending")
    finally:
        ping_task.cancel()
        if drain_task is not None:
            drain_task.cancel()
        # Mid-stream continuity: streams attached to this dying
        # channel PARK in the detached-stream registry (engine generation
        # still running, journal still filling) instead of being killed —
        # their handler tasks now belong to the registry's grace windows,
        # so this session must not cancel them.  Everything else (plain
        # responses, pre-stream dispatches) is cancelled exactly as
        # before.
        parked = global_streams.detach_channel(channel)
        for t in request_tasks:
            if t not in parked:
                t.cancel()


async def _serve_dispatch(
    channel: Channel,
    backend: Backend,
    flow: FlowControl,
    pending: Dict[int, Tuple[RequestHeaders, bytearray]],
    request_tasks: "set[asyncio.Task]",
    max_inflight: int,
    drain: Optional[asyncio.Event],
    msg: TunnelMessage,
    peer_label: str = "",
    resume_cfg: Optional[ResumeConfig] = None,
    features: frozenset = frozenset(),
    kv_pending: Optional[Dict[int, Tuple[KvPagesManifest, bytearray]]] = None,
) -> None:
    """Handle one decoded inbound frame for the serve loop.

    ChannelClosed from any reply send propagates to the caller, which
    distinguishes a drain-close (clean return) from a dead tunnel (retry).

    ``features`` is the negotiated AGREE feature set; the KV_PAGES arms
    only engage when "kvpages" was negotiated AND the backend
    exposes the engine hooks — otherwise transfers get a plain ERROR and
    the proxy falls back to undisaggregated dispatch.  ``kv_pending``
    accumulates in-flight inbound transfers (HDR → CHUNK* → END), keyed
    by stream id like ``pending``.
    """
    if kv_pending is None:
        kv_pending = {}
    if msg.msg_type == MessageType.REQ_HEADERS:
        try:
            headers = RequestHeaders.from_json(msg.payload)
        except ProtocolError as e:
            # One malformed frame must not tear down every stream.
            log.warning("bad REQ_HEADERS payload: %s", e)
            return
        log.debug("request %d %s %s", headers.stream_id, headers.method, headers.path)
        pending[headers.stream_id] = (headers, bytearray())  # tunnelcheck: disable=TC15  multi-frame lifecycle: released by this dispatch's REQ_END arm (pop below); the registry dies with the serve loop's channel on disconnect, and the single reader task owns every entry
    elif msg.msg_type == MessageType.REQ_BODY:
        entry = pending.get(msg.stream_id)
        if entry is not None:
            entry[1].extend(msg.payload)
    elif msg.msg_type == MessageType.REQ_END:
        entry = pending.pop(msg.stream_id, None)
        if entry is not None:
            req, body = entry
            path = req.path.split("?")[0]
            tctx = (parse_trace_context(req.headers)
                    if global_tracer.enabled else None)
            if tctx is not None and global_tracer.on(tctx.trace_id):
                global_tracer.add_event(
                    "serve.frame_recv", trace_id=tctx.trace_id,
                    parent_id=tctx.span_id or None, track="serve",
                    attrs={"stream_id": req.stream_id, "path": path},
                )
            if any(k.lower() == KV_EXPORT_HEADER for k in req.headers):
                # Disaggregated export probe: answered in the
                # KV_PAGES vocabulary by its own task — prefill for a real
                # prompt rides the engine's normal admission path and must
                # not block the serve loop.  Unavailable (no engine hook,
                # feature not negotiated, draining) → plain ERROR, which
                # the proxy reads as "dispatch without pages".
                kv_export = getattr(backend, "kv_export", None)
                if (kv_export is None or "kvpages" not in features
                        or (drain is not None and drain.is_set())):
                    await channel.send(TunnelMessage.error(
                        req.stream_id, "kv export unavailable"
                    ).encode())
                    return
                task = asyncio.create_task(_handle_kv_export(
                    channel, req, bytes(body), flow, kv_export,
                ))
                request_tasks.add(task)
                task.add_done_callback(request_tasks.discard)
                return
            route = http11.ops_route(req.method, req.path)
            if route is not None and route[0] == "healthz":
                # Answered by the serve loop itself (not the backend) so
                # health works identically for the HTTP and TPU backends.
                if "trace=1" in route[1]:
                    # The span journal as Chrome trace-event JSON — load
                    # in chrome://tracing / Perfetto, or summarize with
                    # scripts/traceview.py.  The engine flight recorder's
                    # slice/counter tracks ride the same export (ISSUE
                    # 12): one journal, so the fleet stitcher gives every
                    # peer its own engine-flight lane for free.
                    trace = global_tracer.chrome_trace()
                    trace["traceEvents"] = (
                        list(trace["traceEvents"])
                        + global_flight.chrome_events()
                    )
                    await _send_simple(
                        channel, req.stream_id, 200,
                        json.dumps(trace).encode(),
                        {"content-type": "application/json"},
                    )
                    return
                if "postmortem=1" in route[1]:
                    # The postmortem black box: the most recent
                    # schema-versioned bundle (null when nothing has
                    # triggered), plus the capture count and archive
                    # paths.  Federated per-peer via the proxy's
                    # ?postmortem=1&fleet=1.
                    await _send_simple(
                        channel, req.stream_id, 200,
                        json.dumps(
                            global_blackbox.section(), default=str
                        ).encode(),
                        {"content-type": "application/json"},
                    )
                    return
                stats = getattr(backend, "disagg_stats", None)
                await _send_healthz(
                    channel, req.stream_id,
                    draining=drain is not None and drain.is_set(),
                    inflight=len(request_tasks),
                    peer_label=peer_label,
                    disagg=stats() if stats is not None else None,
                )
                return
            if route is not None and route[0] == "metrics":
                # Prometheus text exposition for the full catalog — also
                # answered by the serve loop itself, so the HTTP and TPU
                # backends expose identical scrape surfaces.  SLO verdicts
                # are refreshed first so the slo_* labeled series a fleet
                # scrape relabels are current at every scrape.
                global_slo.publish()
                await _send_simple(
                    channel, req.stream_id, 200,
                    global_metrics.prometheus_text().encode(),
                    {"content-type": Metrics.PROM_CONTENT_TYPE},
                )
                return
            if drain is not None and drain.is_set():
                global_metrics.inc("serve_shed_total")
                global_slo.record("availability", False)
                if tctx is not None:
                    global_tracer.add_event(
                        "serve.drain_reject", trace_id=tctx.trace_id,
                        parent_id=tctx.span_id or None, track="serve",
                        attrs={"stream_id": req.stream_id},
                    )
                await _send_simple(
                    channel, req.stream_id, 503,
                    b"Service Unavailable: draining",
                )
                await channel.send(TunnelMessage.typed_error(
                    req.stream_id, "draining",
                    "server draining; not admitting new requests",
                ).encode())
                return
            if max_inflight > 0 and len(request_tasks) >= max_inflight:
                # Admission control at the tunnel layer: shed with 429 +
                # Retry-After (HTTP clients) AND a typed `busy` error
                # frame (protocol-aware peers).  The error frame follows
                # RES_END, so the proxy — which forgets the stream at
                # RES_END — is unaffected.
                global_metrics.inc("serve_shed_total")
                global_slo.record("availability", False)
                if tctx is not None:
                    global_tracer.add_event(
                        "serve.shed", trace_id=tctx.trace_id,
                        parent_id=tctx.span_id or None, track="serve",
                        attrs={"stream_id": req.stream_id,
                               "max_inflight": max_inflight},
                    )
                await _send_simple(
                    channel, req.stream_id, 429,
                    b"Too Many Requests: in-flight limit reached",
                    {"retry-after": str(int(
                        _retry_after_s(len(request_tasks)) + 0.5
                    ))},
                )
                await channel.send(TunnelMessage.typed_error(
                    req.stream_id, "busy",
                    f"in-flight limit {max_inflight} reached",
                ).encode())
                return
            task = asyncio.create_task(
                _handle_request(channel, backend, req, bytes(body), flow,
                                peer_label, resume_cfg)
            )
            request_tasks.add(task)
            task.add_done_callback(request_tasks.discard)
    elif msg.msg_type == MessageType.FLOW:
        try:
            credit = msg.flow_credit()
        except ProtocolError as e:
            log.warning("bad FLOW frame: %s", e)
            return
        flow.grant(msg.stream_id, credit)
        # A FLOW grant is also the delivered-bytes ack the replay journal
        # trims on (the proxy grants as its HTTP client consumes): route
        # the watermark to the stream's relay, if it has one.
        global_streams.on_flow(channel, msg.stream_id, credit)
    elif msg.msg_type == MessageType.RES_RESUME:
        # Mid-stream continuity: a reattaching proxy asks for
        # a parked stream spliced at its delivered-byte offset onto THIS
        # stream id.  A resume this peer cannot honor — unknown/expired
        # token, trimmed offset, stale epoch — answers with the typed
        # peer_lost frame the proxy's grace timer would have minted
        # anyway: the failure mode narrows, it never changes shape.
        try:
            rf = ResumeFrame.from_json(msg.payload)
        except ProtocolError as e:
            log.warning("bad RES_RESUME payload: %s", e)
            return
        relay = global_streams.get(rf.token)
        if relay is None:
            await channel.send(TunnelMessage.typed_error(
                msg.stream_id, "peer_lost",
                "unknown or expired resume token",
            ).encode())
            return
        flow.open(msg.stream_id)  # tunnelcheck: disable=TC15  released by StreamRelay: detach/_finish/_fail each close the attachment's flow entry on every pump exit path (the failure branch below closes it inline)
        ok, reason = relay.attach(
            channel, msg.stream_id, flow, rf.offset, rf.epoch,
        )
        if not ok:
            flow.close(msg.stream_id)
            log.warning("refusing resume of %s: %s", rf.token, reason)
            await channel.send(TunnelMessage.typed_error(
                msg.stream_id, "peer_lost", f"cannot resume: {reason}",
            ).encode())
    elif msg.msg_type == MessageType.ERROR:
        # The proxy cancelled one of OUR response streams (it
        # abandoned a resume probe after this peer had already accepted,
        # or gave up on a resumed attachment inside its grace window) —
        # park the relay again instead of pumping frames nobody demuxes,
        # which would wedge the stream at flow-credit exhaustion forever.
        # Stream ids with no attached relay keep the legacy ignore.
        if global_streams.detach_attachment(channel, msg.stream_id):
            log.info("proxy cancelled resumed stream %d: %s; re-parking",
                     msg.stream_id, msg.payload.decode("utf-8", "replace"))
    elif msg.msg_type == MessageType.KV_PAGES_HDR:
        # Inbound disaggregated transfer: the proxy is relaying
        # a prefill peer's pages toward this decode peer on a dedicated
        # stream.  Accumulate HDR → CHUNK* → END, then splice off-loop.
        kv_import = getattr(backend, "kv_import", None)
        if kv_import is None or "kvpages" not in features:
            await channel.send(TunnelMessage.error(
                msg.stream_id, "kv import unavailable"
            ).encode())
            return
        try:
            manifest = KvPagesManifest.from_json(msg.payload)
        except ProtocolError as e:
            log.warning("bad KV_PAGES_HDR payload: %s", e)
            await channel.send(TunnelMessage.error(
                msg.stream_id, f"bad kv manifest: {e}"
            ).encode())
            return
        # The frame header's stream id is authoritative — the manifest was
        # minted on the PREFILL link with that link's stream id and the
        # proxy relays it verbatim.
        manifest.stream_id = msg.stream_id
        kv_pending[msg.stream_id] = (manifest, bytearray())  # tunnelcheck: disable=TC15  multi-frame lifecycle: released by the KV_PAGES_END arm below (pop) or the size-overrun eviction in the CHUNK arm; the registry dies with the serve loop's channel on disconnect
    elif msg.msg_type == MessageType.KV_PAGES_CHUNK:
        kv_entry = kv_pending.get(msg.stream_id)
        if kv_entry is not None:
            kv_entry[1].extend(msg.payload)
            if len(kv_entry[1]) > kv_entry[0].total_bytes():
                # A transfer larger than its own manifest is malformed —
                # stop buffering it NOW (the manifest bounds memory).
                kv_pending.pop(msg.stream_id, None)
                await channel.send(TunnelMessage.error(
                    msg.stream_id, "kv transfer exceeds manifest size"
                ).encode())
    elif msg.msg_type == MessageType.KV_PAGES_END:
        kv_entry = kv_pending.pop(msg.stream_id, None)
        if kv_entry is not None:
            kv_import = getattr(backend, "kv_import", None)
            if kv_import is None:
                await channel.send(TunnelMessage.error(
                    msg.stream_id, "kv import unavailable"
                ).encode())
                return
            task = asyncio.create_task(_handle_kv_import(
                channel, msg.stream_id, kv_entry[0], bytes(kv_entry[1]),
                kv_import,
            ))
            request_tasks.add(task)
            task.add_done_callback(request_tasks.discard)
    elif msg.msg_type == MessageType.PING:
        await channel.send(TunnelMessage.pong().encode())
    elif msg.msg_type == MessageType.PONG:
        log.debug("received pong")
    else:
        log.debug("serve ignoring message type %s", msg.msg_type.name)
