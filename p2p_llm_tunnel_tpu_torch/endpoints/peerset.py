"""Supervised multi-peer fabric for the proxy endpoint.

The proxy used to own exactly ONE :class:`Channel`; a serve-peer death
aborted every in-flight stream and the only recovery was the supervisor
tearing down and re-dialing the whole tunnel.  This module replaces that
single channel with a :class:`PeerSet`: per-peer links, each with its own
handshake, response reader, keepalive (RTT-measuring) and optional tunneled
``/healthz`` probe, plus health-aware least-loaded dispatch and a per-peer
circuit breaker.  A 1-peer PeerSet degenerates to the old behavior — the
single-peer wire exchange is byte-identical.

Health states per link:

- ``live``      — handshake done, answering keepalives, healthz says ok
- ``degraded``  — keepalive RTT above threshold or healthz says degraded;
                  still dispatchable, but only when no live peer exists
- ``draining``  — the peer reported draining (healthz or a typed
                  ``draining`` error frame); NOT dispatchable — it will
                  finish its in-flight streams and die
- ``dead``      — channel closed; pending streams were aborted with a typed
                  ``peer_lost`` event (the proxy re-dispatches the ones that
                  had not yet streamed)

The circuit breaker guards against a peer that stays CONNECTED but keeps
failing dispatches (dead backend, endless header timeouts): after
``CB_THRESHOLD`` consecutive failures the link is skipped for a cooldown,
then a single half-open probe dispatch decides between closing the breaker
and doubling the cooldown.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

from p2p_llm_tunnel_tpu_torch.protocol.frames import (
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
)
from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

log = get_logger(__name__)

HANDSHAKE_TIMEOUT = 300.0  # proxy.rs:72-78
PING_INTERVAL = 10.0  # proxy.rs:93

#: Keepalive RTT above which a live link is marked degraded (and below
#: which a degraded link recovers, health permitting).
DEGRADED_RTT_MS = 2000.0
#: Budget for one tunneled GET /healthz probe.
PROBE_TIMEOUT = 5.0
#: Per-peer budget for one fleet scrape (/metrics?fleet=1, stitched-trace
#: pulls): a dead or wedged peer costs AT MOST this much wall time and
#: yields a staleness marker, never a hang — the scrapes run concurrently,
#: so the whole fleet answer is bounded by the slowest peer, not the sum.
FLEET_SCRAPE_TIMEOUT = 2.0
#: How long a dead peer keeps appearing (as stale) in fleet scrapes after
#: departure: long enough for a dashboard scraping every minute to notice
#: the death, bounded so a long-lived proxy's churn doesn't accrete.
DEPARTED_TTL_S = 600.0
#: Departed-peer memory bound (oldest evicted beyond it).
DEPARTED_CAP = 64

#: Consecutive dispatch failures that open a link's circuit breaker.
CB_THRESHOLD = 3
#: Initial breaker cooldown; doubles per re-opening, capped.
CB_COOLDOWN_S = 5.0
CB_COOLDOWN_MAX_S = 60.0

PEER_LIVE = "live"
PEER_DEGRADED = "degraded"
PEER_DRAINING = "draining"
PEER_DEAD = "dead"


# -- per-stream demux events (formerly proxy-module-private) ----------------

@dataclass
class _Headers:
    headers: ResponseHeaders


@dataclass
class _Body:
    data: bytes


@dataclass
class _Error:
    message: str
    #: Typed ``[code]`` parsed from the payload (or stamped locally by the
    #: abort path) — None for plain reference-style text.
    code: Optional[str] = None


class _End:
    pass


@dataclass
class _Resumed:
    """RES_RESUMED: the serve peer accepted a mid-stream resume and will
    splice its replay journal at ``offset``."""

    offset: int
    epoch: int
    token: str


@dataclass
class _KvHdr:
    """KV_PAGES_HDR: a prefill peer is answering our export probe with a
    page manifest; CHUNK payloads follow as _Body events."""

    manifest: KvPagesManifest


@dataclass
class _KvAck:
    """KV_PAGES_ACK: the decode peer spliced ``spliced`` pages from the
    transfer we pushed."""

    spliced: int


_StreamEvent = Union[_Headers, _Body, _Error, _End, _Resumed, _KvHdr, _KvAck]


def _hrw_score(peer_id: str, key: bytes) -> int:
    """Rendezvous (highest-random-weight) hash: every proxy ranks every
    peer for a given affinity key identically, and a peer join/leave only
    remaps the keys that hashed to the changed peer — exactly the
    stability prefix-affinity routing needs (a rebalance that reshuffled
    every key would cold-start every conversation's prefix)."""
    return int.from_bytes(
        hashlib.blake2b(
            peer_id.encode() + key, digest_size=8
        ).digest(), "big",
    )


class PeerLink:
    """One serve peer: its channel, demux state, and health bookkeeping."""

    def __init__(self, peer_id: str, channel: Channel):
        self.peer_id = peer_id
        self.channel = channel
        self.state = PEER_LIVE
        self.ready = False  # set once HELLO/AGREE completes
        self.flow_enabled = False
        #: Serving role from AGREE: "both" (classic), "prefill"
        #: (takes export probes, skipped for normal dispatch when any
        #: alternative exists), or "decode" (preferred dispatch target in
        #: a disaggregated topology).
        self.role = "both"
        #: Peer negotiated the "kvpages" feature — KV transfers allowed.
        self.kvpages = False
        self.pending: Dict[int, "asyncio.Queue[_StreamEvent]"] = {}
        self.rtt_ms: Optional[float] = None
        self.health = ""  # last /healthz status string ("" = never probed)
        self.consec_failures = 0
        self.breaker_until = 0.0
        self.breaker_level = 0
        self.half_open_inflight = False
        self.admitted_at = time.monotonic()
        self._ping_sent_at: Optional[float] = None
        self._tasks: List[asyncio.Task] = []

    @property
    def inflight(self) -> int:
        return len(self.pending)

    def breaker_open(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) < self.breaker_until

    def dispatchable(self, now: float, enforce_breaker: bool = True) -> bool:
        """Can this link take a new dispatch right now?

        ``enforce_breaker=False`` is the classic single-peer proxy: with
        nowhere else to send, skipping the only channel would turn a slow
        backend into instant 503s — the old proxy forwarded everything,
        and the 1-peer PeerSet must keep doing so.
        """
        if not self.ready or self.state in (PEER_DRAINING, PEER_DEAD):
            return False
        if enforce_breaker and self.breaker_open(now):
            return False
        if (enforce_breaker and self.consec_failures >= CB_THRESHOLD
                and self.half_open_inflight):
            # Breaker cooldown elapsed: exactly one half-open probe at a
            # time decides whether it closes.
            return False
        return True

    def describe(self, now: float) -> dict:
        return {
            "state": self.state,
            "inflight": self.inflight,
            "rtt_ms": round(self.rtt_ms, 1) if self.rtt_ms is not None else None,
            "health": self.health or None,
            "consec_failures": self.consec_failures,
            "breaker_open_for_s": round(max(0.0, self.breaker_until - now), 1),
        }


class PeerSet:
    """Supervised set of serve-peer links with health-aware dispatch.

    ``probe_interval`` > 0 starts a tunneled GET /healthz probe task per
    admitted link (the fabric default); 0 keeps the wire byte-identical to
    the classic single-peer proxy (RTT still rides the existing keepalive
    PINGs, which cost nothing new).
    """

    def __init__(self, probe_interval: float = 0.0, fabric: bool = False):
        self.peers: Dict[str, PeerLink] = {}
        self.probe_interval = probe_interval
        #: Fabric mode (N-peer): health signals may take a peer OUT of the
        #: dispatch set.  Off in the classic single-peer proxy, where e.g.
        #: passively observing a ``draining`` error must NOT stop the proxy
        #: from tunneling to its only peer (the serve side answers drain
        #: sheds itself — byte-identical legacy behavior).
        self.fabric = fabric
        #: Set once ANY peer ever completed its handshake — the "Tunnel not
        #: ready" 503 (pre-handshake) vs "no live serve peer" 503 split.
        self.ever_ready = False
        #: Resolves when the fabric supervisor wants the listener down
        #: (signaling death / shutdown); run_proxy_fabric awaits it.
        self.closed = asyncio.Event()
        #: Recently-dead peers (pid -> departure time): fleet scrapes keep
        #: reporting them — as STALE — for DEPARTED_TTL_S, so a killed
        #: peer's absence from /metrics?fleet=1 is an explicit marker
        #: series, never a silently-vanished set of time series.
        self.departed: Dict[str, float] = {}
        #: Last-known per-peer shed-counter contribution: a TRANSIENT
        #: scrape timeout must not make fleet_sheds_summed dip by a whole
        #: peer's count and snap back — operators rate() that gauge, and
        #: the dip would read as a huge spurious rate excursion.  Stale
        #: peers carry their last-known value until they leave the scrape
        #: set entirely (departed TTL), which IS a peer-set change.
        self._peer_sheds: Dict[str, float] = {}
        self._rr = 0
        self._next_stream_id = 1
        self._id_seq = 0

    # -- stream ids (proxy is the sole allocator, proxy.rs:52) ------------

    def alloc_stream_id(self) -> int:
        sid = self._next_stream_id
        self._next_stream_id += 1
        return sid

    # -- membership -------------------------------------------------------

    def any_ready(self) -> bool:
        return any(l.ready and l.state != PEER_DEAD for l in self.peers.values())

    def live_count(self) -> int:
        return sum(
            1 for l in self.peers.values()
            if l.ready and l.state in (PEER_LIVE, PEER_DEGRADED)
        )

    def total_pending(self) -> int:
        return sum(l.inflight for l in self.peers.values())

    def _publish_gauges(self) -> None:
        global_metrics.set_gauge("proxy_peers_live", self.live_count())
        global_metrics.set_gauge("proxy_streams_in_flight", self.total_pending())

    async def admit(self, channel: Channel, peer_id: Optional[str] = None) -> PeerLink:
        """Handshake ``channel`` and add it as a dispatchable link.

        Raises RuntimeError on handshake failure — the per-peer supervisor
        (or run_proxy's retry loop) owns the redial.
        """
        if peer_id is None:
            peer_id = f"peer-{self._id_seq}"
            self._id_seq += 1
        link = PeerLink(peer_id, channel)
        self.departed.pop(peer_id, None)  # a rejoin is no longer departed
        if not channel.connected.is_set():
            log.info("waiting for channel to be ready...")
            await channel.connected.wait()
        log.info("channel ready, performing handshake...")
        # Fabric handshakes stamp the assigned peer id into HELLO (the
        # Hello.peer extension) so the serve side can tag its spans and
        # /healthz with the identity this proxy's fleet surfaces use; the
        # classic single-peer handshake stays byte-identical.
        hello = Hello(peer=peer_id) if self.fabric else Hello()
        await channel.send(TunnelMessage.hello(hello).encode())
        try:
            raw = await asyncio.wait_for(channel.recv(), HANDSHAKE_TIMEOUT)
        except asyncio.TimeoutError:
            raise RuntimeError(
                "handshake timeout: no AGREE received within 5 minutes"
            )
        except ChannelClosed:
            raise RuntimeError("channel closed before handshake")
        agree_msg = TunnelMessage.decode(raw)
        if agree_msg.msg_type != MessageType.AGREE:
            raise RuntimeError(f"expected AGREE, got {agree_msg.msg_type.name}")
        agree = Agree.from_json(agree_msg.payload)
        log.info("received AGREE: version=%d features=%s role=%s",
                 agree.version, agree.features, agree.role)
        link.flow_enabled = "flow" in agree.features
        link.role = agree.role
        link.kvpages = "kvpages" in agree.features
        link.ready = True
        self.peers[peer_id] = link
        self.ever_ready = True
        link._tasks.append(asyncio.create_task(self._reader(link)))
        link._tasks.append(asyncio.create_task(self._keepalive(link)))
        if self.probe_interval > 0:
            link._tasks.append(asyncio.create_task(self._prober(link)))
        self._publish_gauges()
        return link

    # -- dispatch policy (ReplicaRouter's pick, proxy-side) ---------------

    def pick(self, exclude: Iterable[str] = (),
             affinity: Optional[bytes] = None) -> Optional[PeerLink]:
        """Health-aware least-loaded link, round-robin tiebreak.

        Live peers win over degraded ones; draining/dead/breaker-open links
        are skipped.  A link whose breaker cooldown just elapsed is
        admitted as the single half-open probe.

        ``affinity`` is the request's prefix-chain affinity key:
        when present, the pick WITHIN the best health tier is the
        rendezvous-hash winner instead of the least-loaded link, so
        same-prefix requests land on the peer whose pool already holds the
        chain.  Health always overrides affinity — a degraded/draining/
        breaker-open favorite loses the request to a healthy peer exactly
        as before; affinity only replaces the tie-break among equals.
        Prefill-role peers are skipped for normal dispatch whenever any
        alternative exists (they serve export probes, not clients).
        """
        now = time.monotonic()
        excluded = set(exclude)
        candidates = [
            l for l in self.peers.values()
            if l.peer_id not in excluded
            and l.dispatchable(now, enforce_breaker=self.fabric)
        ]
        non_prefill = [l for l in candidates if l.role != "prefill"]
        if non_prefill:
            candidates = non_prefill
        if not candidates:
            return None
        if affinity:
            tier = min(0 if l.state == PEER_LIVE else 1 for l in candidates)
            pool = [
                l for l in candidates
                if (0 if l.state == PEER_LIVE else 1) == tier
            ]
            chosen = max(
                pool, key=lambda l: _hrw_score(l.peer_id, affinity)
            )
            if len(pool) > 1:
                # Only meaningful when affinity actually had a choice to
                # make — a 1-candidate "hit" would just count dispatches.
                global_metrics.inc("proxy_affinity_hits_total")
        else:
            key = lambda l: (0 if l.state == PEER_LIVE else 1, l.inflight)
            low = min(key(l) for l in candidates)
            lowest = [l for l in candidates if key(l) == low]
            self._rr = (self._rr + 1) % len(lowest)
            chosen = lowest[self._rr % len(lowest)]
        if self.fabric and chosen.consec_failures >= CB_THRESHOLD:
            # Past-cooldown pick of a tripped link IS the half-open probe.
            chosen.half_open_inflight = True
        return chosen

    def kv_prefill_peer(self, exclude: Iterable[str] = ()) -> Optional[PeerLink]:
        """The link to send a disaggregated export probe to:
        a dispatchable prefill-role peer that negotiated "kvpages", or
        None — in which case the proxy simply dispatches undisaggregated.
        """
        now = time.monotonic()
        excluded = set(exclude)
        pool = [
            l for l in self.peers.values()
            if l.peer_id not in excluded and l.role == "prefill"
            and l.kvpages
            and l.dispatchable(now, enforce_breaker=self.fabric)
        ]
        if not pool:
            return None
        return min(
            pool, key=lambda l: (0 if l.state == PEER_LIVE else 1, l.inflight)
        )

    def resume_candidates(
        self, prefer_peer_id: str, exclude: Iterable[str] = (),
        died_at: float = 0.0,
    ) -> List[PeerLink]:
        """Links worth sending a RES_RESUME to, best-first.

        The replay journal lives in one serve PROCESS, so the best
        candidate is a link that re-dialed under the dead peer's id;
        next, links admitted AFTER the death (a rejoined process gets a
        fresh id from the fabric); lastly any other ready link — a wrong
        process answers the unknown token with a fast typed refusal, so
        probing it costs one round trip, never the grace window.
        ``exclude`` holds peer ids already refused for this resume.
        """
        excluded = set(exclude)
        out = [
            l for l in self.peers.values()
            if l.ready and l.state not in (PEER_DEAD, PEER_DRAINING)
            and l.peer_id not in excluded
        ]

        def rank(l: PeerLink) -> Tuple[int, float]:
            if l.peer_id == prefer_peer_id:
                return (0, 0.0)
            if l.admitted_at >= died_at:
                return (1, -l.admitted_at)  # newest rejoin first
            return (2, 0.0)

        return sorted(out, key=rank)

    # -- circuit breaker --------------------------------------------------

    def record_failure(self, link: PeerLink) -> None:
        """One dispatch-level failure (send died, upstream error/timeout
        before headers, peer death mid-dispatch)."""
        link.half_open_inflight = False
        link.consec_failures += 1
        if (self.fabric
                and link.consec_failures >= CB_THRESHOLD
                and not link.breaker_open()
                and link.state != PEER_DEAD):
            cooldown = min(
                CB_COOLDOWN_S * (2 ** link.breaker_level), CB_COOLDOWN_MAX_S
            )
            # Jitter so a fleet of proxies doesn't re-probe in lockstep.
            cooldown *= 1.0 + random.uniform(0.0, 0.25)
            link.breaker_until = time.monotonic() + cooldown
            link.breaker_level += 1
            global_metrics.inc("proxy_circuit_open_total")
            log.warning(
                "peer %s circuit breaker OPEN for %.1fs after %d consecutive "
                "failures", link.peer_id, cooldown, link.consec_failures,
            )

    def record_success(self, link: PeerLink) -> None:
        if link.consec_failures >= CB_THRESHOLD:
            log.info("peer %s circuit breaker closed (half-open probe ok)",
                     link.peer_id)
        link.consec_failures = 0
        link.breaker_level = 0
        link.breaker_until = 0.0
        link.half_open_inflight = False

    # -- death / teardown -------------------------------------------------

    def _abort_link(self, link: PeerLink, err: TunnelMessage) -> None:
        """Wake every stream pending on ``link`` with a typed error event
        so no handler hangs (the old module-global ``_abort_pending``,
        scoped per peer and typed per the ERROR_CODES registry)."""
        text = err.payload.decode("utf-8", "replace")
        code = err.error_code()
        for sid, q in list(link.pending.items()):
            q.put_nowait(_Error(text, code))
        link.pending.clear()
        self._publish_gauges()

    def mark_dead(self, link: PeerLink, err: TunnelMessage) -> None:
        """Transition a link to dead: abort its streams (typed), drop it
        from the dispatchable set, cancel its tasks."""
        if link.state == PEER_DEAD:
            return
        link.state = PEER_DEAD
        log.warning("serve peer %s lost (%d stream(s) in flight)",
                    link.peer_id, link.inflight)
        self._abort_link(link, err)
        self.peers.pop(link.peer_id, None)
        self.departed.pop(link.peer_id, None)  # re-insert at newest
        self.departed[link.peer_id] = time.monotonic()
        while len(self.departed) > DEPARTED_CAP:
            self.departed.pop(next(iter(self.departed)))
        self._publish_gauges()
        current = asyncio.current_task()
        for t in link._tasks:
            if t is not current:
                t.cancel()

    def remove(self, peer_id: str, err: TunnelMessage) -> None:
        """External removal (signaling peer-left, fabric teardown)."""
        link = self.peers.get(peer_id)
        if link is not None:
            link.channel.close()
            self.mark_dead(link, err)

    def close(self, err: TunnelMessage) -> None:
        """Tear every link down (proxy shutdown / full reconnect)."""
        for link in list(self.peers.values()):
            link.channel.close()
            self.mark_dead(link, err)
        self.closed.set()

    # -- per-link tasks ----------------------------------------------------

    async def _reader(self, link: PeerLink) -> None:
        """Demux one link's frames into its per-stream event queues
        (proxy.rs:105-172, scoped per peer)."""
        channel = link.channel
        while True:
            try:
                raw = await channel.recv()
            except ChannelClosed:
                log.debug("response reader ended: channel closed (%s)",
                          link.peer_id)
                self.mark_dead(link, TunnelMessage.typed_error(
                    0, "peer_lost", "tunnel closed"))
                return
            try:
                msg = TunnelMessage.decode(raw)
            except ProtocolError as e:
                log.warning("failed to decode tunnel message: %s", e)
                continue

            if msg.msg_type == MessageType.RES_HEADERS:
                try:
                    headers = ResponseHeaders.from_json(msg.payload)
                except ProtocolError as e:
                    log.error("failed to parse response headers: %s", e)
                    continue
                q = link.pending.get(headers.stream_id)
                if q is not None:
                    q.put_nowait(_Headers(headers))
            elif msg.msg_type == MessageType.RES_BODY:
                q = link.pending.get(msg.stream_id)
                if q is not None:
                    q.put_nowait(_Body(msg.payload))
            elif msg.msg_type == MessageType.RES_END:
                q = link.pending.pop(msg.stream_id, None)
                if q is not None:
                    q.put_nowait(_End())
                    self._publish_gauges()
            elif msg.msg_type == MessageType.RES_RESUMED:
                try:
                    rf = ResumeFrame.from_json(msg.payload)
                except ProtocolError as e:
                    log.warning("bad RES_RESUMED payload: %s", e)
                    continue
                q = link.pending.get(msg.stream_id)
                if q is not None:
                    q.put_nowait(_Resumed(rf.offset, rf.epoch, rf.token))
            elif msg.msg_type == MessageType.ERROR:
                text = msg.payload.decode("utf-8", "replace")
                code = msg.error_code()
                if (self.fabric and code == "draining"
                        and link.state != PEER_DEAD):
                    # The peer told us it is draining — stop dispatching to
                    # it before the drain finishes and the channel dies.
                    # Fabric-only: the single-peer proxy keeps tunneling to
                    # its draining peer so clients see the serve side's own
                    # 503 [draining] answers, exactly as before.
                    if link.state != PEER_DRAINING:
                        log.info("peer %s reported draining", link.peer_id)
                    link.state = PEER_DRAINING
                    self._publish_gauges()
                q = link.pending.pop(msg.stream_id, None)
                if q is not None:
                    log.error("tunnel error for stream %d: %s",
                              msg.stream_id, text)
                    q.put_nowait(_Error(text, code))
                    self._publish_gauges()
                else:
                    # Expected, not an anomaly: serve relays a backend
                    # shed's typed code ([busy]/[tenant_overlimit]) AFTER
                    # RES_END, by which point this demux has already
                    # forgotten the stream.  Error-level here would emit
                    # one misleading line per shed — exactly under the
                    # overload the typed codes exist for.
                    log.debug("post-stream tunnel error for %d: %s",
                              msg.stream_id, text)
            elif msg.msg_type == MessageType.KV_PAGES_HDR:
                # Disaggregated transfer answers: a prefill peer
                # responding to our export probe.  CHUNK payloads reuse the
                # _Body event; END reuses _End — the consuming helper knows
                # which vocabulary it asked for.
                try:
                    manifest = KvPagesManifest.from_json(msg.payload)
                except ProtocolError as e:
                    log.warning("bad KV_PAGES_HDR payload: %s", e)
                    continue
                q = link.pending.get(msg.stream_id)
                if q is not None:
                    q.put_nowait(_KvHdr(manifest))
            elif msg.msg_type == MessageType.KV_PAGES_CHUNK:
                q = link.pending.get(msg.stream_id)
                if q is not None:
                    q.put_nowait(_Body(msg.payload))
            elif msg.msg_type == MessageType.KV_PAGES_END:
                q = link.pending.pop(msg.stream_id, None)
                if q is not None:
                    q.put_nowait(_End())
                    self._publish_gauges()
            elif msg.msg_type == MessageType.KV_PAGES_ACK:
                q = link.pending.pop(msg.stream_id, None)
                if q is not None:
                    try:
                        q.put_nowait(_KvAck(msg.kv_ack_spliced()))
                    except ProtocolError as e:
                        log.warning("bad KV_PAGES_ACK payload: %s", e)
                        q.put_nowait(_Error("bad kv ack", None))
                    self._publish_gauges()
            elif msg.msg_type == MessageType.PING:
                try:
                    await channel.send(TunnelMessage.pong().encode())
                except ChannelClosed:
                    self.mark_dead(link, TunnelMessage.typed_error(
                        0, "peer_lost", "tunnel closed"))
                    return
            elif msg.msg_type == MessageType.PONG:
                log.debug("received pong")
                self._note_pong(link)
            else:
                log.debug("proxy ignoring message type %s", msg.msg_type.name)

    def _note_pong(self, link: PeerLink) -> None:
        """Keepalive RTT sample → live/degraded transitions."""
        if link._ping_sent_at is None:
            return
        link.rtt_ms = (time.monotonic() - link._ping_sent_at) * 1000.0
        link._ping_sent_at = None
        if link.state == PEER_LIVE and link.rtt_ms > DEGRADED_RTT_MS:
            log.warning("peer %s degraded: keepalive RTT %.0fms",
                        link.peer_id, link.rtt_ms)
            link.state = PEER_DEGRADED
        elif (link.state == PEER_DEGRADED
              and link.rtt_ms <= DEGRADED_RTT_MS
              and link.health in ("", "ok")):
            log.info("peer %s recovered: keepalive RTT %.0fms",
                     link.peer_id, link.rtt_ms)
            link.state = PEER_LIVE
        self._publish_gauges()

    async def _keepalive(self, link: PeerLink) -> None:
        while True:
            await asyncio.sleep(PING_INTERVAL)
            link._ping_sent_at = time.monotonic()
            try:
                await link.channel.send(TunnelMessage.ping().encode())
            except ChannelClosed:
                return

    async def _prober(self, link: PeerLink) -> None:
        while True:
            await asyncio.sleep(self.probe_interval)
            if link.state == PEER_DEAD:
                return
            try:
                await self.probe(link)
            except ChannelClosed:
                return

    async def fetch(self, link: PeerLink, path: str,
                    timeout: float = PROBE_TIMEOUT) -> Optional[bytes]:
        """One tunneled GET on ``link``: the full response body (whatever
        the HTTP status) within ``timeout``, else None — a dead, wedged,
        or erroring peer costs bounded wall time, never a hang.  The
        timeout covers the SENDS too: a peer that stopped reading (full
        TCP buffer, stalled ARQ window) blocks ``channel.send`` itself,
        and an unbounded send would hang the whole fleet scrape.  The
        transport machinery every tunneled ops pull shares (health probes,
        /metrics?fleet=1 scrapes, stitched-trace journal pulls).
        ChannelClosed from the sends propagates to the caller."""
        sid = self.alloc_stream_id()
        q: "asyncio.Queue[_StreamEvent]" = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded by the ops endpoint's own response (a handful of frames); the stream is torn down at `timeout`
        link.pending[sid] = q
        try:
            return await asyncio.wait_for(
                self._fetch_inner(link, sid, path, q), timeout
            )
        except asyncio.TimeoutError:
            return None
        finally:
            link.pending.pop(sid, None)

    async def _fetch_inner(
        self, link: PeerLink, sid: int, path: str,
        q: "asyncio.Queue[_StreamEvent]",
    ) -> Optional[bytes]:
        await link.channel.send(TunnelMessage.req_headers(
            RequestHeaders(sid, "GET", path, {})
        ).encode())
        await link.channel.send(TunnelMessage.req_end(sid).encode())
        body = bytearray()
        while True:
            ev = await q.get()
            if isinstance(ev, _Body):
                body.extend(ev.data)
            elif isinstance(ev, _End):
                return bytes(body)
            elif isinstance(ev, _Error):
                return None

    async def probe(self, link: PeerLink) -> Optional[str]:
        """One tunneled GET /healthz; applies the reported status to the
        link's health state.  Returns the status string, or None when the
        probe timed out (which marks the link degraded)."""
        body = await self.fetch(link, "/healthz", PROBE_TIMEOUT)
        if body is None:
            if link.state == PEER_LIVE:
                log.warning("peer %s degraded: healthz probe failed",
                            link.peer_id)
                link.state = PEER_DEGRADED
                self._publish_gauges()
            return None
        try:
            status = str(json.loads(body).get("status", ""))
        except (json.JSONDecodeError, ValueError):
            status = ""
        self.apply_health(link, status)
        return status

    # -- disaggregated KV transfers ----------------------------

    async def kv_export_fetch(
        self, link: PeerLink, req: RequestHeaders, body: bytes,
        timeout: float,
    ) -> Optional[Tuple[KvPagesManifest, bytes]]:
        """Ask a prefill peer to prefill ``req`` and ship its KV pages.

        Sends the original request (method/path/headers/body unchanged)
        on a DEDICATED stream tagged KV_EXPORT_HEADER; the peer answers in
        the KV_PAGES vocabulary or a plain ERROR.  Returns (manifest,
        page bytes) or None on refusal/timeout/death — every None means
        "dispatch without pages", never a client-visible failure.  The
        transfer stream is flow-controlled like a response body: credit is
        granted back as chunks are consumed here.
        """
        sid = self.alloc_stream_id()
        q: "asyncio.Queue[_StreamEvent]" = asyncio.Queue()  # tunnelcheck: disable=TC10  bounded in bytes by the transfer's own flow-control credit window; the stream is torn down at `timeout`
        link.pending[sid] = q
        try:
            return await asyncio.wait_for(
                self._kv_export_inner(link, sid, req, body, q), timeout
            )
        except (asyncio.TimeoutError, ChannelClosed):
            return None
        finally:
            link.pending.pop(sid, None)

    async def _kv_export_inner(
        self, link: PeerLink, sid: int, req: RequestHeaders, body: bytes,
        q: "asyncio.Queue[_StreamEvent]",
    ) -> Optional[Tuple[KvPagesManifest, bytes]]:
        headers = dict(req.headers)
        headers[KV_EXPORT_HEADER] = "1"
        await link.channel.send(TunnelMessage.req_headers(
            RequestHeaders(sid, req.method, req.path, headers)
        ).encode())
        for off in range(0, len(body), MAX_BODY_CHUNK):
            await link.channel.send(TunnelMessage.req_body(
                sid, body[off:off + MAX_BODY_CHUNK]
            ).encode())
        await link.channel.send(TunnelMessage.req_end(sid).encode())
        manifest: Optional[KvPagesManifest] = None
        buf = bytearray()
        while True:
            ev = await q.get()
            if isinstance(ev, _KvHdr):
                manifest = ev.manifest
            elif isinstance(ev, _Body):
                buf.extend(ev.data)
                if link.flow_enabled:
                    # The serve side debits its per-stream credit per
                    # chunk exactly like a response body — replenish as
                    # we consume, or a transfer > INITIAL_CREDIT stalls.
                    await link.channel.send(
                        TunnelMessage.flow(sid, len(ev.data)).encode()
                    )
            elif isinstance(ev, _End):
                if manifest is None or manifest.total_bytes() != len(buf):
                    return None
                return manifest, bytes(buf)
            elif isinstance(ev, (_Error, _KvAck)):
                # ERROR = typed/plain refusal ("no pages", draining, pin
                # trouble); an ACK here is a protocol mixup.  Either way:
                # no pages.
                return None

    async def kv_splice_push(
        self, link: PeerLink, manifest: KvPagesManifest, blob: bytes,
        timeout: float,
    ) -> Optional[int]:
        """Relay an exported transfer to a decode peer and await its ACK.

        Opens a DEDICATED stream on ``link`` (request direction — these
        frames carry no RES_* machinery), pushes HDR + CHUNK* + END, and
        returns the spliced-page count from KV_PAGES_ACK — or None on a
        typed ``page_pin`` refusal, malformed-transfer ERROR, timeout, or
        link death.  None tells the proxy the decode peer will re-prefill
        locally; the follow-up request is dispatched either way.
        """
        sid = self.alloc_stream_id()
        q: "asyncio.Queue[_StreamEvent]" = asyncio.Queue()  # tunnelcheck: disable=TC10  receives exactly one ACK or ERROR event; the stream is torn down at `timeout`
        link.pending[sid] = q
        try:
            return await asyncio.wait_for(
                self._kv_splice_inner(link, sid, manifest, blob, q), timeout
            )
        except (asyncio.TimeoutError, ChannelClosed):
            return None
        finally:
            link.pending.pop(sid, None)

    async def _kv_splice_inner(
        self, link: PeerLink, sid: int, manifest: KvPagesManifest,
        blob: bytes, q: "asyncio.Queue[_StreamEvent]",
    ) -> Optional[int]:
        manifest.stream_id = sid
        await link.channel.send(TunnelMessage.kv_pages_hdr(manifest).encode())
        for off in range(0, len(blob), MAX_BODY_CHUNK):
            await link.channel.send(TunnelMessage.kv_pages_chunk(
                sid, blob[off:off + MAX_BODY_CHUNK]
            ).encode())
        await link.channel.send(TunnelMessage.kv_pages_end(sid).encode())
        while True:
            ev = await q.get()
            if isinstance(ev, _KvAck):
                return ev.spliced
            if isinstance(ev, (_Error, _End)):
                return None

    # -- fleet scraping -----------------------------------------

    async def scrape_fleet(
        self, path: str, timeout: float = FLEET_SCRAPE_TIMEOUT
    ) -> Dict[str, Optional[bytes]]:
        """Concurrently GET ``path`` from every admitted peer.

        Returns ``{peer_id: body | None}`` — None marks a STALE peer (the
        scrape failed, timed out, or the peer recently died: recently-
        departed peers are included so their staleness is an explicit
        series, not a vanished one).  Wall time is bounded by ``timeout``
        (scrapes run concurrently; a dead peer can never hang the fleet
        answer).
        """
        links = [
            l for l in list(self.peers.values())
            if l.ready and l.state != PEER_DEAD
        ]

        async def one(link: PeerLink) -> Optional[bytes]:
            try:
                return await self.fetch(link, path, timeout)
            except ChannelClosed:
                return None

        bodies = await asyncio.gather(*(one(l) for l in links))
        out: Dict[str, Optional[bytes]] = {
            l.peer_id: b for l, b in zip(links, bodies)
        }
        now = time.monotonic()
        for pid, t_dead in list(self.departed.items()):
            if now - t_dead > DEPARTED_TTL_S:
                self.departed.pop(pid, None)
            else:
                out.setdefault(pid, None)
        return out

    def publish_fleet_gauges(
        self, texts: "Dict[str, Optional[str]]"
    ) -> None:
        """Fold a fleet scrape into the catalogued ``fleet_*`` aggregates
        (the proxy-process registry): peers live/degraded, summed
        in-flight, fleet-wide shed total and redispatch rate, and the
        per-peer staleness markers — the same numbers /healthz?local=1
        serves as its ``fleet`` section."""
        from p2p_llm_tunnel_tpu_torch.utils.metrics import sum_counter_samples

        global_metrics.set_gauge("fleet_peers_live", self.live_count())
        global_metrics.set_gauge("fleet_peers_degraded", sum(
            1 for l in self.peers.values()
            if l.ready and l.state == PEER_DEGRADED
        ))
        global_metrics.set_gauge(
            "fleet_streams_in_flight", self.total_pending()
        )
        for pid, text in texts.items():
            if text is not None:
                one = {pid: text}
                self._peer_sheds[pid] = (
                    sum_counter_samples(one, "serve_shed_total")
                    + sum_counter_samples(one, "engine_tenant_sheds_total")
                )
        for pid in [p for p in self._peer_sheds if p not in texts]:
            del self._peer_sheds[pid]
        global_metrics.set_gauge(
            "fleet_sheds_summed", sum(self._peer_sheds.values())
        )
        global_metrics.set_gauge(
            "fleet_redispatch_per_s",
            global_metrics.rate("proxy_redispatch_total", window_s=60.0),
        )
        for pid, text in texts.items():
            global_metrics.set_labeled_gauge(
                "fleet_peer_scrape_stale", "peer", pid,
                0.0 if text is not None else 1.0,
            )
        # A departed peer past DEPARTED_TTL_S leaves the scrape set — its
        # marker must leave the exposition with it, not read 1 forever.
        global_metrics.prune_labeled_gauge(
            "fleet_peer_scrape_stale", set(texts)
        )

    def apply_health(self, link: PeerLink, status: str) -> None:
        """Fold a /healthz-reported status into the link state."""
        if link.state == PEER_DEAD:
            return
        link.health = status
        if status == "draining":
            if link.state != PEER_DRAINING:
                log.info("peer %s reported draining", link.peer_id)
            link.state = PEER_DRAINING
        elif status == "degraded":
            if link.state == PEER_LIVE:
                log.warning("peer %s degraded (healthz)", link.peer_id)
                link.state = PEER_DEGRADED
        elif status == "ok":
            if (link.state == PEER_DEGRADED
                    and (link.rtt_ms is None
                         or link.rtt_ms <= DEGRADED_RTT_MS)):
                log.info("peer %s recovered (healthz ok)", link.peer_id)
                link.state = PEER_LIVE
        self._publish_gauges()

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        """The fabric-health JSON served at GET /healthz?local=1."""
        now = time.monotonic()
        live = self.live_count()
        if live and any(
            l.state == PEER_LIVE for l in self.peers.values() if l.ready
        ):
            status = "ok"
        elif live:
            status = "degraded"
        else:
            status = "down"
        return {
            "status": status,
            "peers_live": live,
            "streams_in_flight": self.total_pending(),
            "redispatch_total": int(
                global_metrics.counter("proxy_redispatch_total")
            ),
            "circuit_open_total": int(
                global_metrics.counter("proxy_circuit_open_total")
            ),
            "failover_p50_ms": round(
                global_metrics.percentile("proxy_failover_ms", 50), 1
            ),
            # Mid-stream continuity: link-death -> first
            # resumed byte, for streams that reattached instead of
            # surfacing the typed peer_lost terminal.
            "stream_resume_p50_ms": round(
                global_metrics.percentile("proxy_stream_resume_ms", 50), 1
            ),
            "peers": {
                pid: link.describe(now) for pid, link in self.peers.items()
            },
            # Fleet aggregates: the /metrics?fleet=1 numbers as
            # a JSON section.  Live membership counts are computed HERE
            # (current); the scrape-derived ones (sheds_summed, staleness)
            # are the last fleet scrape's — zero/empty before the first —
            # because this surface must answer instantly with every peer
            # down, never scrape.
            "fleet": {
                "peers_live": live,
                "peers_degraded": sum(
                    1 for l in self.peers.values()
                    if l.ready and l.state == PEER_DEGRADED
                ),
                "streams_in_flight": self.total_pending(),
                "sheds_summed": int(
                    global_metrics.gauge("fleet_sheds_summed")
                ),
                "redispatch_per_s": round(
                    global_metrics.gauge("fleet_redispatch_per_s"), 3
                ),
                "stale_peers": sorted(
                    pid for pid, v in global_metrics.labeled_gauge(
                        "fleet_peer_scrape_stale"
                    ).items() if v > 0
                ),
            },
        }
