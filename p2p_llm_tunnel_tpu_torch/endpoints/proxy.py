"""Proxy (consumer) endpoint: local HTTP/1.1 listener → tunnel frames → back.

Reference behavior being matched (tunnel/src/proxy.rs):
- send HELLO, await AGREE ≤300 s (proxy.rs:64-88), then mark tunnel ready
- 503 "Tunnel not ready" before the handshake completes (:257-263)
- keepalive ping every 10 s (:91-103); answer PING with PONG (:154-162)
- response-reader task demuxes RES_*/ERROR frames into per-stream event
  queues (:105-172)
- stream ids allocated from a counter starting at 1 — the proxy is the sole
  allocator (:52, :265)
- request bodies fully buffered before sending (:280-289), chunked to
  MAX_BODY_CHUNK (:318-330)
- 504 on response-header timeout (60 s, :339-341, :367-375); 502 on tunnel
  error before headers (:360-366); hop-by-hop headers stripped from the
  rebuilt response (:379-388)
- mid-stream ERROR truncates the body without an HTTP error (:408-412)

Beyond the reference: the proxy's single channel is a supervised
:class:`~p2p_llm_tunnel_tpu_torch.endpoints.peerset.PeerSet` — N serve peers with
independent lifecycles, health-routed least-loaded dispatch, per-peer
circuit breakers, and transparent re-dispatch: a request whose serve peer
dies BEFORE it started streaming is retried on a surviving peer (bounded
attempts, capped backoff + jitter, deadline budget respected); a request
already streaming fails fast with a typed ``peer_lost`` error.  A 1-peer
PeerSet — the classic ``run_proxy`` path — is byte-identical to the old
single-channel proxy, except that abort errors now carry typed
``[peer_lost]`` / ``[tunnel_reset]`` codes.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from typing import AsyncIterator, Dict, Optional

from p2p_llm_tunnel_tpu_torch.endpoints.http11 import (
    HttpRequest,
    HttpResponse,
    ops_route,
    start_http_server,
)
from p2p_llm_tunnel_tpu_torch.endpoints.peerset import (  # noqa: F401  (re-exported)
    HANDSHAKE_TIMEOUT,
    PING_INTERVAL,
    PeerLink,
    PeerSet,
    _Body,
    _End,
    _Error,
    _Headers,
    _Resumed,
    _StreamEvent,
)
from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    CREDIT_BATCH,
    TENANT_HEADER,
    MessageType,
    RequestHeaders,
    ResumeFrame,
    TunnelMessage,
    encode_body_frames,
    parse_deadline_ms,
    parse_tenant,
)
from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import (
    Metrics,
    federate_prometheus_texts,
    global_metrics,
)
from p2p_llm_tunnel_tpu_torch.utils.tracing import (
    TRACE_HEADER,
    global_tracer,
    mint_trace_id,
    new_span_id,
    parse_trace_context,
)

log = get_logger(__name__)

RESPONSE_HEADER_TIMEOUT = 60.0  # proxy.rs:339-341

#: Re-dispatch policy after a peer death: at most this many total
#: dispatch attempts per request (1 initial + N-1 failovers), with capped
#: exponential backoff + jitter between attempts.
MAX_DISPATCH_ATTEMPTS = 4
REDISPATCH_BACKOFF_S = 0.05
REDISPATCH_BACKOFF_MAX_S = 1.0
#: Advisory Retry-After attached to terminal peer_lost/no-peer failures —
#: the serve peers' supervisors redial on this order of backoff.
PEER_LOST_RETRY_AFTER_S = 2

#: Per-candidate budget for one RES_RESUME round trip: a peer
#: that holds the journal answers immediately; a wrong or wedged peer
#: must cost one bounded probe, never the whole grace window.
RESUME_PROBE_TIMEOUT = 2.0
#: Poll interval while waiting for a resume candidate (a re-dialed peer)
#: to appear in the PeerSet.
RESUME_POLL_S = 0.05

_HOP_BY_HOP_RESPONSE = {"transfer-encoding", "connection"}


class ProxyState(PeerSet):
    """Shared state between the HTTP handler and the per-peer readers.

    The old single-channel ProxyState, generalized: it IS the PeerSet.
    Constructing it with a channel prepares (but does not handshake) the
    classic single-peer link — ``handle_proxy_request`` answers 503 until a
    handshake completes, exactly as before.
    """

    def __init__(self, channel: Optional[Channel] = None,
                 tenant_fallback: str = "",
                 trust_tenant_header: bool = False,
                 probe_interval: float = 0.0,
                 fabric: bool = False):
        super().__init__(probe_interval=probe_interval, fabric=fabric)
        #: The classic single-peer channel (None in fabric mode).
        self.channel = channel
        #: Tenant identity stamped on requests that carry neither an
        #: x-api-key nor an x-tunnel-tenant header — typically the room
        #: name, so one proxy connection is one accountable tenant.
        self.tenant_fallback = tenant_fallback
        #: Honor a client-sent x-tunnel-tenant at THIS listener.  Off by
        #: default: a public-facing proxy that trusted the label would let
        #: one client mint a fresh tenant per request, sidestepping its own
        #: fair-share cap and crushing every real tenant's share toward the
        #: floor of 1 (see frames.parse_tenant).  Opt in only when a
        #: trusted edge stamps the header.
        self.trust_tenant_header = trust_tenant_header

    @property
    def tunnel_ready(self) -> bool:
        return self.any_ready()


def _plain(status: int, text: str,
           headers: Optional[Dict[str, str]] = None) -> HttpResponse:
    h = {"content-type": "text/plain"}
    if headers:
        h.update(headers)
    return HttpResponse(status, h, text.encode())


#: Methods the failover loop may replay after the request was FULLY SENT
#: to a peer that then died pre-headers (RFC 9110 §9.2.2 idempotent set).
#: A non-idempotent request in that window may already have executed on
#: the dead peer's backend — replaying it would double the side effects —
#: so it surfaces the typed peer_lost error instead, unless the client
#: opted in via the x-tunnel-idempotent header.
IDEMPOTENT_METHODS = frozenset(
    {"GET", "HEAD", "OPTIONS", "PUT", "DELETE", "TRACE"}
)
#: Client opt-in: "x-tunnel-idempotent: 1" marks a POST safe to replay
#: across peer failover (the client deduplicates, or the work is pure).
IDEMPOTENT_HEADER = "x-tunnel-idempotent"


class _DispatchFailed:
    """One dispatch attempt died retryably (peer lost / send failed).

    ``retry_safe`` is False when the request reached the peer whole and
    is not idempotent — the failover loop must surface the typed error
    instead of silently re-executing it.
    """

    def __init__(self, message: str, t_fail: float, retry_safe: bool = True):
        self.message = message
        self.t_fail = t_fail
        self.retry_safe = retry_safe


async def _fleet_metrics_response(state: ProxyState) -> HttpResponse:
    """GET /metrics?fleet=1: every live peer's /metrics scraped
    concurrently over the tunnel (bounded per-peer timeout — a dead or
    slow peer yields a ``fleet_peer_scrape_stale`` marker, never a hang),
    merged with a ``peer="..."`` label on every serve/engine-side series,
    plus the proxy's own proxy_* series and the ``fleet_*`` aggregates."""
    scrapes = await state.scrape_fleet("/metrics")
    texts = {
        pid: (body.decode("utf-8", "replace") if body is not None else None)
        for pid, body in scrapes.items()
    }
    # Aggregates + staleness markers land in THIS registry first, so the
    # local exposition section below (and /healthz?local=1's fleet
    # section) carries them.
    state.publish_fleet_gauges(texts)
    return HttpResponse(
        200, {"content-type": Metrics.PROM_CONTENT_TYPE},
        federate_prometheus_texts(
            texts, global_metrics.prometheus_text()
        ).encode(),
    )


async def _fleet_trace_response(state: ProxyState) -> HttpResponse:
    """GET /healthz?trace=1&fleet=1: pull every live peer's span
    journal over the tunnel and stitch them — with this process's own
    ingress journal — into ONE Chrome trace with per-peer process lanes,
    so a failed-over request shows sibling serve.dispatch spans on two
    peer lanes under a single trace id.  Peers whose journal could not be
    pulled (dead, slow, evicted) are flagged in the ``stitch`` summary;
    partial chains are flagged, never an error."""
    import json as _json

    from p2p_llm_tunnel_tpu_torch.utils.tracing import stitch_chrome_traces

    scrapes = await state.scrape_fleet("/healthz?trace=1")
    sources: Dict[str, Optional[dict]] = {
        "proxy": global_tracer.chrome_trace()
    }
    for pid, body in scrapes.items():
        if body is None:
            sources[pid] = None
            continue
        try:
            obj = _json.loads(body)
            sources[pid] = obj if isinstance(obj, dict) else None
        except ValueError:
            sources[pid] = None
    return HttpResponse(
        200, {"content-type": "application/json"},
        _json.dumps(stitch_chrome_traces(sources)).encode(),
    )


async def _fleet_postmortem_response(state: ProxyState) -> HttpResponse:
    """GET /healthz?postmortem=1&fleet=1: every peer's latest
    postmortem bundle pulled concurrently over the tunnel via the same
    bounded PeerSet.fetch machinery as the metric scrapes — a dead or
    wedged peer yields a null entry in ``stale``, never a hang.  The
    proxy's OWN black box rides along as the ``proxy`` entry (a drain
    timeout in this process captures here)."""
    import json as _json

    from p2p_llm_tunnel_tpu_torch.utils.flight import global_blackbox

    scrapes = await state.scrape_fleet("/healthz?postmortem=1")
    peers: Dict[str, Optional[dict]] = {
        "proxy": global_blackbox.section()
    }
    stale = []
    for pid, body in scrapes.items():
        if body is None:
            peers[pid] = None
            stale.append(pid)
            continue
        try:
            obj = _json.loads(body)
            peers[pid] = obj if isinstance(obj, dict) else None
        except ValueError:
            peers[pid] = None
            stale.append(pid)
    return HttpResponse(
        200, {"content-type": "application/json"},
        _json.dumps(
            {"peers": peers, "stale": sorted(stale)}, default=str
        ).encode(),
    )


#: Generation paths whose requests carry a prompt worth affinity-routing
#: and disaggregating (the engine API's four serving surfaces).
_GEN_PATHS = frozenset({
    "/v1/chat/completions", "/v1/completions", "/api/generate", "/api/chat",
})

#: Budget for one disaggregated handoff leg (export fetch, splice push).
#: Blown budget = fall back to undisaggregated dispatch, never an error.
DISAGG_XFER_TIMEOUT = 30.0


def _affinity_key(req: HttpRequest) -> Optional[bytes]:
    """The request's prefix-chain affinity key, or None.

    Same-prefix requests must hash identically, so the key is the stable
    ROOT of the prefix chain: a chat conversation's first message content
    (turn N keeps routing where turns 1..N-1 warmed the pool), or the
    first 256 bytes of a completion prompt.  Non-generation paths and
    unparseable bodies return None — those dispatch least-loaded exactly
    as before.
    """
    path = req.path.split("?")[0]
    if path not in _GEN_PATHS:
        return None
    try:
        payload = json.loads(req.body or b"{}")
    except ValueError:
        return None
    if not isinstance(payload, dict):
        return None
    if path in ("/v1/chat/completions", "/api/chat"):
        msgs = payload.get("messages")
        if isinstance(msgs, list) and msgs and isinstance(msgs[0], dict):
            root = str(msgs[0].get("content", ""))
            return root.encode("utf-8", "replace")[:256] or None
        return None
    prompt = payload.get("prompt", "")
    if isinstance(prompt, list):
        prompt = prompt[0] if prompt else ""
    return str(prompt).encode("utf-8", "replace")[:256] or None


async def _disagg_handoff(
    state: ProxyState, pre: PeerLink, target: PeerLink,
    req: HttpRequest, headers_out_tunnel: Dict[str, str],
) -> None:
    """One disaggregated prefill→decode handoff, best-effort.

    Sends the request to the prefill peer as an export probe (it runs
    admission + prefill and ships the prompt's KV pages), then relays the
    transfer to the decode target, which splices the pages into its own
    pool through the two-phase verify/commit path.  The follow-up
    dispatch is wire-unchanged — the decode peer's own prefix match finds
    the spliced pages by content address.

    NEVER raises and never blocks the request beyond the transfer
    budget: any refusal, pin mismatch, timeout, or peer death counts a
    fallback and the request dispatches undisaggregated — disaggregation
    is a pure optimization, not a new failure mode.
    """
    t0 = time.monotonic()
    try:
        tun_req = RequestHeaders(
            0, req.method, req.path, headers_out_tunnel,
        )
        got = await state.kv_export_fetch(
            pre, tun_req, req.body, DISAGG_XFER_TIMEOUT,
        )
        if got is None:
            global_metrics.inc("proxy_disagg_fallbacks_total")
            return
        manifest, blob = got
        spliced = await state.kv_splice_push(
            target, manifest, blob, DISAGG_XFER_TIMEOUT,
        )
        if spliced is None:
            # None = the transfer itself failed (refusal, timeout, dead
            # peer).  An ack of ZERO pages is a completed transfer — the
            # target already holds every offered page — not a fallback.
            global_metrics.inc("proxy_disagg_fallbacks_total")
            return
        global_metrics.inc("proxy_disagg_handoffs_total")
        log.debug(
            "disagg handoff %s -> %s: %d page(s), %d bytes, %.1fms",
            pre.peer_id, target.peer_id, spliced, len(blob),
            (time.monotonic() - t0) * 1000.0,
        )
    except Exception as e:  # best-effort by contract
        log.warning("disagg handoff failed: %s", e)
        global_metrics.inc("proxy_disagg_fallbacks_total")


async def handle_proxy_request(state: ProxyState, req: HttpRequest) -> HttpResponse:
    """One HTTP request through the tunnel (proxy.rs:249-426), with
    health-routed dispatch and transparent failover across the PeerSet."""
    route = ops_route(req.method, req.path)
    if route is not None and route[0] == "metrics":
        flags = route[1]
        if "fleet=1" in flags:
            return await _fleet_metrics_response(state)
        if "local=1" in flags:
            # GET /metrics?local=1: THIS process's registry (the proxy-side
            # proxy_*/transport_* series live here, not behind the tunnel),
            # answered locally so it works even while the tunnel is down.
            # Bare /metrics tunnels through to the serve peer like /healthz —
            # in the deployed two-process topology the proxy listener is the
            # only HTTP surface, and a local answer there would render the
            # engine_*/serve_* series as silent zeros (the TC06 bug class).
            return HttpResponse(
                200, {"content-type": Metrics.PROM_CONTENT_TYPE},
                global_metrics.prometheus_text().encode(),
            )
    if route is not None and route[0] == "healthz":
        flags = route[1]
        if {"trace=1", "fleet=1"} <= flags:
            return await _fleet_trace_response(state)
        if {"postmortem=1", "fleet=1"} <= flags:
            # Bare ?postmortem=1 tunnels through to the serve peer's own
            # black box like bare /healthz; with fleet=1 the proxy
            # federates every peer's bundle.
            return await _fleet_postmortem_response(state)
        if {"trace=1", "local=1"} <= flags:
            # GET /healthz?trace=1&local=1: THIS process's span journal —
            # in the two-process topology the proxy's ingress spans
            # (proxy.request/frame_send/first_byte) live in this ring
            # buffer, not the serve peer's; without this escape the
            # documented capture flow would silently lose the proxy layer.
            # Bare ?trace=1 tunnels through to the serve+engine journal;
            # ?trace=1&fleet=1 stitches ALL the journals (above).
            import json as _json

            return HttpResponse(
                200, {"content-type": "application/json"},
                _json.dumps(global_tracer.chrome_trace()).encode(),
            )
        if "local=1" in flags:
            # GET /healthz?local=1: the proxy's OWN fabric health — peer
            # states, per-peer RTT/breaker/inflight, failover counters
            # plus the fleet aggregates section.
            # Answered locally: it must work while every serve peer is
            # down (that is exactly when an operator needs it).
            import json as _json

            snap = state.snapshot()
            return HttpResponse(
                200 if snap["status"] == "ok" else 503,
                {"content-type": "application/json"},
                _json.dumps(snap).encode(),
            )

    if not state.any_ready():
        if state.ever_ready:
            # The tunnel WAS up and every serve peer has since died — a
            # different operator story than "still handshaking", and a
            # retryable one (peer supervisors are redialing on this order
            # of backoff).
            return _plain(
                503, "Tunnel error: [peer_lost] no live serve peer",
                {"retry-after": str(PEER_LOST_RETRY_AFTER_S)},
            )
        return _plain(503, "Tunnel not ready")

    t_start = time.monotonic()
    global_metrics.inc("proxy_requests_total")
    # Tenant identity: normalized HERE, at the tunnel's ingress —
    # an explicit x-tunnel-tenant wins (only behind --trust-tenant-header;
    # a public listener honoring it would let clients mint identities and
    # defeat fair admission), else the FINGERPRINT of the client's
    # x-api-key (the label is exported on /metrics and /healthz; the raw
    # credential never becomes an identity), else this proxy's
    # connection-scoped fallback (the room name).  The
    # canonical header rides RequestHeaders across the tunnel so serve +
    # engine fair-admit and account per tenant without re-deriving.
    tenant = parse_tenant(req.headers, state.tenant_fallback,
                          trust_label=state.trust_tenant_header)
    log.debug("proxying %s %s", req.method, req.path)

    # Trace context: accept the client's x-tunnel-trace or mint a
    # fresh trace id here — the proxy is the tunnel's ingress, so this is
    # where a request's one trace id is decided.  When the trace records
    # (enabled + sampled, decided once by hashing the id), the outgoing
    # header re-parents downstream spans under this proxy.request span.
    # Everything is gated on `enabled` so the disabled default costs zero
    # per-request work on the ingress hot path (a client-sent header still
    # forwards untouched via the plain header copy below).
    inbound = root_span = None
    trace_id = ""
    if global_tracer.enabled:
        inbound = parse_trace_context(req.headers)
        trace_id = (inbound.trace_id if inbound is not None
                    else mint_trace_id())
        root_span = new_span_id() if global_tracer.on(trace_id) else None
    span_done = False

    def finish_span(status: int, peer_id: str = "", attempts: int = 0) -> None:
        nonlocal span_done
        if root_span is None or span_done:
            return
        span_done = True
        attrs = {"method": req.method, "path": req.path, "status": status}
        if tenant:
            attrs["tenant"] = tenant
        if peer_id:
            attrs["peer"] = peer_id
        if attempts:
            attrs["redispatches"] = attempts
        global_tracer.add_span(
            "proxy.request", trace_id=trace_id, span_id=root_span,
            parent_id=(inbound.span_id or None) if inbound else None,
            track="proxy", t0=t_start, attrs=attrs,
        )

    headers_out_tunnel = dict(req.headers)
    # Drop any client-sent case-variant UNCONDITIONALLY — not just when a
    # normalized stamp replaces it: inside the tunnel the header is trusted
    # (api.parse_tenant's proxy-stamped default), so a raw copy surviving a
    # no-identity request would hand the client the exact identity-minting
    # hole the untrusted-listener default closes.  When a tenant was
    # derived, the stamped value must also be the ONLY one on the wire, or
    # downstream lookups could read the raw (untruncated, unstripped) copy.
    for k in [k for k in headers_out_tunnel
              if k.lower() == TENANT_HEADER]:
        del headers_out_tunnel[k]
    if tenant:
        headers_out_tunnel[TENANT_HEADER] = tenant
    if root_span is not None:
        headers_out_tunnel[TRACE_HEADER] = f"{trace_id}/{root_span}"
    # The SAME identity + trace headers ride every dispatch attempt, so
    # tenant-fair accounting and the span chain survive a failover intact.

    # The client's deadline budget bounds the RETRY loop only — the serve
    # peer still enforces it per attempt (the proxy re-dispatching past the
    # budget would waste a surviving peer's slot on a lost cause).
    dl_ms = parse_deadline_ms(req.headers)
    overall_deadline = t_start + dl_ms / 1000.0 if dl_ms is not None else None

    idempotent = req.method.upper() in IDEMPOTENT_METHODS or any(
        k.lower() == IDEMPOTENT_HEADER and v.strip() == "1"
        for k, v in req.headers.items()
    )

    # Prefix-affinity routing + disaggregation: generation
    # requests carry a stable affinity key so same-prefix traffic lands on
    # the peer whose pool is already warm; health still overrides (pick()
    # only applies affinity within the best health tier).
    affinity = _affinity_key(req)

    failures = 0
    tried: set = set()
    first_fail_t: Optional[float] = None
    while True:
        link = state.pick(exclude=tried, affinity=affinity)
        if link is None and tried:
            # Every untried peer is gone; a previously-tried one may have
            # recovered (or be the only one left) — better than failing.
            link = state.pick(affinity=affinity)
        if link is None:
            finish_span(503, attempts=failures)
            return _plain(
                503, "Tunnel error: [peer_lost] no live serve peer",
                {"retry-after": str(PEER_LOST_RETRY_AFTER_S)},
            )
        if (affinity is not None and failures == 0
                and link.kvpages and link.role != "prefill"):
            # Disaggregated handoff (first attempt only — a failover is
            # already paying a latency bill): if a prefill-role peer is
            # up, have it prefill this prompt and ship the KV pages to
            # the chosen decode target before the request itself goes
            # out.  Best-effort: every failure path inside falls back to
            # plain dispatch.
            pre = state.kv_prefill_peer(exclude=(link.peer_id,))
            if pre is not None:
                await _disagg_handoff(
                    state, pre, link, req, headers_out_tunnel,
                )
        outcome = await _dispatch_once(
            state, link, req, headers_out_tunnel, t_start, first_fail_t,
            trace_id, root_span, finish_span, failures, idempotent,
        )
        if not isinstance(outcome, _DispatchFailed):
            return outcome
        failures += 1
        if not outcome.retry_safe:
            # The dead peer received the whole non-idempotent request and
            # may have executed it — replaying could double the side
            # effects, so the client gets the typed error and decides.
            finish_span(502, peer_id=link.peer_id, attempts=failures)
            return _plain(
                502, f"Tunnel error: {outcome.message} "
                     "(not replayed: non-idempotent request may have "
                     f"executed; retry or send {IDEMPOTENT_HEADER}: 1)",
                {"retry-after": str(PEER_LOST_RETRY_AFTER_S)},
            )
        tried.add(link.peer_id)
        if first_fail_t is None:
            first_fail_t = outcome.t_fail
        now = time.monotonic()
        if failures >= MAX_DISPATCH_ATTEMPTS or (
                overall_deadline is not None and now >= overall_deadline):
            finish_span(502, peer_id=link.peer_id, attempts=failures)
            return _plain(
                502, f"Tunnel error: {outcome.message}",
                {"retry-after": str(PEER_LOST_RETRY_AFTER_S)},
            )
        global_metrics.inc("proxy_redispatch_total")
        # Capped exponential backoff + jitter before the next peer — a
        # herd of re-dispatched streams must not stampede the survivor.
        backoff = min(REDISPATCH_BACKOFF_S * (2 ** (failures - 1)),
                      REDISPATCH_BACKOFF_MAX_S)
        backoff *= 1.0 + random.uniform(0.0, 0.5)
        if overall_deadline is not None:
            backoff = min(backoff, max(0.0, overall_deadline - now))
        await asyncio.sleep(backoff)
        log.info("re-dispatching %s %s after peer loss (attempt %d)",
                 req.method, req.path, failures + 1)


async def _dispatch_once(
    state: ProxyState,
    link: PeerLink,
    req: HttpRequest,
    headers_out_tunnel: Dict[str, str],
    t_start: float,
    first_fail_t: Optional[float],
    trace_id: str,
    root_span: Optional[str],
    finish_span,
    prior_failures: int,
    idempotent: bool = True,
) -> "HttpResponse | _DispatchFailed":
    """One dispatch attempt on one peer link.

    Returns the HttpResponse (success OR a terminal error response), or a
    :class:`_DispatchFailed` when the peer died before this request started
    streaming — the caller's failover loop re-dispatches those.
    """
    channel = link.channel
    stream_id = state.alloc_stream_id()
    log.debug("dispatching %s %s (stream %d) on peer %s",
              req.method, req.path, stream_id, link.peer_id)

    events: asyncio.Queue[_StreamEvent] = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded in BYTES by FLOW credit: the serve peer stops emitting at INITIAL_CREDIT unacked bytes until body_stream() below grants more; against a no-"flow" reference peer the bound is the upstream's own response pacing (documented reference behavior)
    link.pending[stream_id] = events
    global_metrics.set_gauge("proxy_streams_in_flight", state.total_pending())

    def drop_stream(l: Optional[PeerLink] = None,
                    sid: Optional[int] = None) -> None:
        """Forget one stream registration — defaults to the original
        (link, stream_id); a resumed stream passes its CURRENT binding."""
        if l is None:
            link.pending.pop(stream_id, None)
        else:
            l.pending.pop(sid, None)
        global_metrics.set_gauge(
            "proxy_streams_in_flight", state.total_pending())

    t_send = time.monotonic()
    sent_any = False
    try:
        await channel.send(
            TunnelMessage.req_headers(
                RequestHeaders(stream_id, req.method, req.path,
                               headers_out_tunnel)
            ).encode()
        )
        sent_any = True
        for frame in encode_body_frames(MessageType.REQ_BODY, stream_id, req.body):
            await channel.send(frame)
        await channel.send(TunnelMessage.req_end(stream_id).encode())
    except ChannelClosed:
        drop_stream()
        state.record_failure(link)
        # A request the peer never saw a byte of is always replayable;
        # a partially/fully sent one only if idempotent.
        return _DispatchFailed("[peer_lost] tunnel send failed",
                               time.monotonic(),
                               retry_safe=idempotent or not sent_any)
    if root_span is not None:
        global_tracer.add_span(
            "proxy.frame_send", trace_id=trace_id, parent_id=root_span,
            track="proxy", t0=t_send,
            attrs={"body_bytes": len(req.body), "peer": link.peer_id},
        )

    # Wait for response headers (proxy.rs:338-376).
    res_headers = None
    deadline = time.monotonic() + RESPONSE_HEADER_TIMEOUT
    while res_headers is None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            drop_stream()
            state.record_failure(link)
            finish_span(504, peer_id=link.peer_id)
            return _plain(504, "Tunnel response timeout")
        try:
            event = await asyncio.wait_for(events.get(), remaining)
        except asyncio.TimeoutError:
            drop_stream()
            state.record_failure(link)
            finish_span(504, peer_id=link.peer_id)
            return _plain(504, "Tunnel response timeout")
        if isinstance(event, _Headers):
            res_headers = event.headers
        elif isinstance(event, _Error):
            drop_stream()
            if event.code == "peer_lost":
                # The peer died before this request streamed a byte —
                # the one case failover can transparently absorb (the
                # whole request reached the peer, so non-idempotent ones
                # surface the typed error instead of re-executing).
                state.record_failure(link)
                return _DispatchFailed(event.message, time.monotonic(),
                                       retry_safe=idempotent)
            if event.code in ("busy", "draining", "timeout",
                              "tenant_overlimit"):
                # A typed shed IS the peer's serve loop answering: the
                # link works (this must clear a half-open probe rather
                # than wedge it); the shed itself is a load or
                # client-budget signal, not a peer fault.
                state.record_success(link)
            else:
                # Untyped, upstream, tunnel_reset, or unknown-prefix
                # errors count toward the peer's breaker.
                state.record_failure(link)
            finish_span(502, peer_id=link.peer_id)
            return _plain(502, f"Tunnel error: {event.message}")
        elif isinstance(event, _End):
            drop_stream()
            state.record_failure(link)
            finish_span(502, peer_id=link.peer_id)
            return _plain(502, "Tunnel error: response ended before headers")
        else:
            log.warning("received body chunk before headers for stream %d",
                        stream_id)

    # Headers arrived: the dispatch succeeded (whatever the HTTP status —
    # a 429/503 is the backend answering, not the peer failing).
    state.record_success(link)
    if first_fail_t is not None:
        # This request survived a peer death via re-dispatch: the gap from
        # the ORIGINAL failure to streaming again is the measured failover
        # recovery time.
        global_metrics.observe(
            "proxy_failover_ms", (time.monotonic() - first_fail_t) * 1000.0
        )

    headers_out = {
        k: v
        for k, v in res_headers.headers.items()
        if k.lower() not in _HOP_BY_HOP_RESPONSE
    }
    ctype = res_headers.headers.get(
        "content-type", res_headers.headers.get("Content-Type", "")).lower()
    is_sse = "text/event-stream" in ctype
    # The ollama-style /api/generate //api/chat stream: one JSON object per
    # line — the OTHER streaming vocabulary a typed terminal error can ride.
    is_ndjson = "ndjson" in ctype

    # Mid-stream continuity: a resumable stream's RES_HEADERS
    # carries a serve-minted resume token + the serve side's grace window.
    # On a mid-stream peer loss the response is held open while the fabric
    # re-dial / breaker half-open probe recovers the peer, then RES_RESUME
    # splices the replay journal at exactly the delivered-byte offset —
    # the client-observed body is byte-identical to an uninterrupted run.
    resume_token = res_headers.resume
    resume_grace = res_headers.grace

    async def body_stream() -> AsyncIterator[bytes]:
        cur_link = link
        cur_sid = stream_id
        cur_events = events
        first = True
        delivered = 0  # absolute body bytes the HTTP client has consumed
        epoch = 0      # last RES_RESUMED epoch (0 = original attachment)
        ungranted = 0  # bytes relayed since the last FLOW grant
        try:
            while True:
                event = await cur_events.get()
                if isinstance(event, _Body):
                    if first:
                        global_metrics.observe(
                            "proxy_ttfb_ms", (time.monotonic() - t_start) * 1000.0
                        )
                        if root_span is not None:
                            global_tracer.add_event(
                                "proxy.first_byte", trace_id=trace_id,
                                parent_id=root_span, track="proxy",
                            )
                        first = False
                    global_metrics.inc("proxy_body_bytes_total", len(event.data))
                    yield event.data
                    # The chunk reached the HTTP client (yield resumes after
                    # the writer drains) — count it delivered (the offset a
                    # resume splices at) and replenish the serve side's
                    # credit in CREDIT_BATCH steps.
                    delivered += len(event.data)
                    if cur_link.flow_enabled:
                        ungranted += len(event.data)
                        if ungranted >= CREDIT_BATCH:
                            try:
                                await cur_link.channel.send(
                                    TunnelMessage.flow(cur_sid, ungranted).encode()
                                )
                                ungranted = 0
                            except ChannelClosed:
                                pass  # the reader will surface the death
                elif isinstance(event, (_End, _Error)):
                    # ERROR mid-stream truncates the body silently
                    # (proxy.rs:408-412) — HTTP status already went out.
                    if isinstance(event, _Error):
                        if (event.code == "peer_lost" and resume_token
                                and resume_grace > 0
                                and not state.closed.is_set()):
                            # Hold the response open for the grace window
                            # and try to reattach; only when that fails
                            # does today's typed terminal fire — the
                            # failure mode narrows, never changes shape.
                            t_died = time.monotonic()
                            got = await _attempt_resume(
                                state, cur_link.peer_id, resume_token,
                                delivered, epoch, resume_grace, t_died,
                            )
                            if got is not None:
                                cur_link, cur_sid, cur_events, epoch = got
                                ungranted = 0
                                global_metrics.observe(
                                    "proxy_stream_resume_ms",
                                    (time.monotonic() - t_died) * 1000.0,
                                )
                                log.info(
                                    "stream %d resumed on peer %s at byte "
                                    "%d (epoch %d)", cur_sid,
                                    cur_link.peer_id, delivered, epoch,
                                )
                                continue
                        log.warning(
                            "tunnel error mid-stream for %d: %s", cur_sid, event.message
                        )
                        if ((is_sse or is_ndjson) and not first
                                and event.code in ("peer_lost",
                                                   "tunnel_reset")):
                            # A streaming request cannot be re-dispatched
                            # (bytes already reached the client); give it a
                            # TYPED terminal event instead of a silent
                            # truncation, so protocol-aware consumers can
                            # distinguish "peer died" from "stream done" —
                            # framed as an SSE event or an NDJSON line to
                            # match the stream's own vocabulary.  Chunked
                            # transfer only (http11 strips content-length
                            # for streamed bodies), and only for the
                            # proxy-minted codes that cannot occur on the
                            # reference wire.
                            import json as _json

                            payload = _json.dumps({"error": {
                                "code": event.code,
                                "message": event.message,
                                "retry_after_s": PEER_LOST_RETRY_AFTER_S,
                            }})
                            yield ((f"data: {payload}\n\n" if is_sse
                                    else payload + "\n").encode())
                    return
                elif isinstance(event, _Resumed):
                    log.warning("unexpected RES_RESUMED for stream %d", cur_sid)
                else:
                    log.warning("unexpected duplicate headers for stream %d", cur_sid)
        finally:
            drop_stream(cur_link, cur_sid)
            finish_span(res_headers.status, peer_id=cur_link.peer_id,
                        attempts=prior_failures)

    return HttpResponse(res_headers.status, headers_out, body_stream())


async def _attempt_resume(
    state: ProxyState, dead_peer_id: str, token: str, delivered: int,
    epoch: int, grace_s: float, died_at: float,
):
    """Reattach a mid-stream request after its peer link died.

    Waits up to the serve-advertised grace window for a candidate link
    (the dead peer's id re-dialed, a freshly-admitted rejoin, or any
    ready peer — a wrong process refuses the token in one bounded round
    trip), sends RES_RESUME with the DELIVERED byte offset, and returns
    ``(link, stream_id, events_queue, epoch)`` on RES_RESUMED — the
    journal tail then arrives as ordinary RES_BODY frames.  None when the
    window expires or every candidate refused: the caller falls back to
    today's typed ``peer_lost`` terminal.
    """
    deadline = died_at + grace_s
    refused: set = set()      # id(link) of links that REFUSED the token
    probes: dict = {}         # id(link) -> (link, sid, queue) awaiting answer
    accepted = None

    def _probe_answer(link2, sid, q, ev):
        """Fold one demux event into the probe bookkeeping."""
        nonlocal accepted
        if (isinstance(ev, _Resumed) and ev.token == token
                and ev.offset == delivered):
            accepted = (link2, sid, q, ev.epoch)
            return
        link2.pending.pop(sid, None)
        probes.pop(id(link2), None)
        refused.add(id(link2))
        if isinstance(ev, _Error):
            log.info("peer %s refused resume: %s", link2.peer_id, ev.message)

    async def _abandon(link2, sid) -> None:
        """Tell the serve peer this probe is dead — if it had already
        ACCEPTED (answer in flight), its relay must re-park rather than
        pump a stream id nobody demuxes until credit exhaustion."""
        link2.pending.pop(sid, None)
        try:
            await link2.channel.send(TunnelMessage.typed_error(
                sid, "peer_lost", "resume abandoned by proxy",
            ).encode())
        except ChannelClosed:
            pass

    try:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or state.closed.is_set():
                return None
            # A slow probe's answer may land AFTER its wait below timed
            # out — keep polling every outstanding queue, so a late
            # accept is taken instead of orphaned.
            for lid, (link2, sid, q) in list(probes.items()):
                while accepted is None and not q.empty():
                    _probe_answer(link2, sid, q, q.get_nowait())
            if accepted is not None:
                return accepted
            # Exclusions are per LINK, not per peer id: a peer that
            # re-dials under its old id is a fresh link holding the
            # journal — a transient failure on its previous incarnation
            # must not bar it for the rest of the window.
            candidates = [
                l for l in state.resume_candidates(
                    dead_peer_id, died_at=died_at)
                if id(l) not in refused and id(l) not in probes
            ]
            if not candidates:
                await asyncio.sleep(min(RESUME_POLL_S, remaining))
                continue
            link2 = candidates[0]
            sid = state.alloc_stream_id()
            q: "asyncio.Queue[_StreamEvent]" = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded in BYTES by FLOW credit once resumed (the serve relay stops at INITIAL_CREDIT unacked bytes); pre-resume it holds exactly one RES_RESUMED/ERROR answer
            link2.pending[sid] = q
            probes[id(link2)] = (link2, sid, q)
            try:
                await link2.channel.send(TunnelMessage.res_resume(
                    ResumeFrame(sid, token, delivered, epoch)
                ).encode())
                ev = await asyncio.wait_for(
                    q.get(), min(remaining, RESUME_PROBE_TIMEOUT)
                )
            except ChannelClosed:
                link2.pending.pop(sid, None)
                probes.pop(id(link2), None)
                continue
            except asyncio.TimeoutError:
                # Leave the probe outstanding: its answer may still come
                # (polled above); meanwhile try another candidate.
                continue
            _probe_answer(link2, sid, q, ev)
            if accepted is not None:
                return accepted
    finally:
        # Give-up or success: no probe may stay half-open.  An accepted
        # attachment we are NOT taking is explicitly cancelled so the
        # serve side re-parks it (grace window) instead of wedging.
        for link2, sid, q in list(probes.values()):
            if accepted is not None and link2 is accepted[0] \
                    and sid == accepted[1]:
                continue
            await _abandon(link2, sid)


async def run_proxy(
    channel: Channel,
    listen_host: str = "127.0.0.1",
    listen_port: int = 8000,
    ready: Optional["asyncio.Future[int]"] = None,
    tenant_fallback: str = "",
    trust_tenant_header: bool = False,
) -> None:
    """Run the consumer side until the tunnel dies; raises to trigger retry.

    The classic single-peer entry point: a 1-link PeerSet over ``channel``,
    byte-identical to the pre-fabric proxy.  ``run_proxy_fabric`` is the
    N-peer twin.

    ``ready`` (optional) resolves to the bound port once the listener is up —
    the programmatic readiness signal (the reference greps logs instead,
    scripts/test-tunnel.sh:79-86).

    ``tenant_fallback`` stamps x-tunnel-tenant on requests that carry no
    API key — the CLI passes the room name, so untagged traffic through
    one proxy connection is one accountable tenant.

    ``trust_tenant_header`` honors a client-sent x-tunnel-tenant at this
    listener (default off — see ProxyState; enable only behind a trusted
    edge, otherwise identities are minted from API keys or the fallback).
    """
    state = ProxyState(channel, tenant_fallback=tenant_fallback,
                       trust_tenant_header=trust_tenant_header)

    await state.admit(channel)

    server = None
    try:
        async def handler(req: HttpRequest) -> HttpResponse:
            return await handle_proxy_request(state, req)

        server = await start_http_server(handler, listen_host, listen_port)
        bound_port = server.sockets[0].getsockname()[1]
        log.info("proxy listening on http://%s:%d", listen_host, bound_port)
        if ready is not None and not ready.done():
            ready.set_result(bound_port)
        await channel.disconnected.wait()
        raise RuntimeError("tunnel connection failed, exiting proxy to trigger reconnect")
    finally:
        state.close(TunnelMessage.typed_error(
            0, "tunnel_reset", "proxy shutting down"))
        if server is not None:
            server.close()
            try:
                await asyncio.wait_for(server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                log.warning("proxy listener did not close cleanly within 5s")


async def run_proxy_fabric(
    state: ProxyState,
    listen_host: str = "127.0.0.1",
    listen_port: int = 8000,
    ready: Optional["asyncio.Future[int]"] = None,
) -> None:
    """HTTP listener over an externally-supervised PeerSet.

    Unlike ``run_proxy``, a single peer death does NOT end the listener —
    peers come and go under their own supervision (``transport/fabric.py``
    admits and removes them); the listener runs until ``state.closed`` is
    set (signaling death or shutdown), then aborts what remains.
    """
    server = None
    try:
        async def handler(req: HttpRequest) -> HttpResponse:
            return await handle_proxy_request(state, req)

        server = await start_http_server(handler, listen_host, listen_port)
        bound_port = server.sockets[0].getsockname()[1]
        log.info("proxy fabric listening on http://%s:%d",
                 listen_host, bound_port)
        if ready is not None and not ready.done():
            ready.set_result(bound_port)
        await state.closed.wait()
        raise RuntimeError(
            "fabric supervision ended, exiting proxy to trigger reconnect")
    finally:
        state.close(TunnelMessage.typed_error(
            0, "tunnel_reset", "proxy shutting down"))
        if server is not None:
            server.close()
            try:
                await asyncio.wait_for(server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                log.warning("proxy listener did not close cleanly within 5s")
