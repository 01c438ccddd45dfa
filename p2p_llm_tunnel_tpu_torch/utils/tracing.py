"""Request-scope distributed tracing: span journal + Chrome-trace export.

The metrics registry (utils/metrics.py) answers AGGREGATE questions — tok/s,
queue depth, TTFT percentiles.  This module answers the per-request one the
registry cannot: *where did request N's 900 ms go?*  A trace context (trace
id + parent span id) is minted at the proxy (or accepted from an inbound
``x-tunnel-trace`` header, the ``x-tunnel-deadline-ms`` precedent), carried
in ``RequestHeaders.headers`` across the tunnel, and picked up by serve and
the engine — producing host-timestamped spans for the full request
lifecycle that export as Chrome trace-event / Perfetto JSON
(``GET /healthz?trace=1``; summarize with ``scripts/traceview.py``).

Design constraints, in priority order:

- **Pure host code.**  Monotonic clocks and a deque under a lock — zero
  device dispatches, zero jax imports, so recording can never add a sync
  to the serving path (the TC07 contract; tunnelcheck TC09 statically
  forbids emission calls inside jitted/scanned functions).
- **Off by default, sampled in production.**  The recorder is a no-op until
  ``configure(enabled=True)`` (serve/proxy ``--trace``); ``sample`` keeps a
  deterministic per-trace fraction, decided by hashing the trace id so
  every layer of one request agrees with zero coordination.
- **Bounded.**  Spans land in a ring buffer (``capacity`` records); steady
  state costs O(1) memory and the export is always serveable.

Every literal span name handed to :meth:`TraceRecorder.add_span` /
:meth:`TraceRecorder.add_event` must be declared in :data:`SPAN_CATALOG` —
enforced statically by tunnelcheck rule TC09 (the TC06 pattern), so a
typo'd span name cannot silently split a request's timeline.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

#: The one catalogue of legal span names.  ``<layer>.<what>``; duration
#: spans unless the description says "instant".
SPAN_CATALOG: Dict[str, str] = {
    # -- proxy (consumer peer) -------------------------------------------
    "proxy.request": (
        "one HTTP request through the tunnel: ingress -> last body byte "
        "relayed (root span when the client sent no x-tunnel-trace)"
    ),
    "proxy.frame_send": (
        "REQ_HEADERS + body frames + REQ_END onto the tunnel channel"
    ),
    "proxy.first_byte": (
        "first response-body byte reached the HTTP client (instant; the "
        "proxy_ttfb_ms histogram's per-request twin)"
    ),
    # -- serve (provider peer) -------------------------------------------
    "serve.frame_recv": (
        "a request's REQ_END arrived and it is about to dispatch (instant)"
    ),
    "serve.dispatch": (
        "backend call + response relay for one tunneled request: REQ_END "
        "-> RES_END (parent of the engine's spans)"
    ),
    "serve.timeout": (
        "the request blew its x-tunnel-deadline-ms budget at the serve "
        "layer; a typed [timeout] frame follows (instant)"
    ),
    "serve.shed": (
        "admission control shed the request: 429 + typed [busy] (instant)"
    ),
    "serve.drain_reject": (
        "request refused because the server is draining: 503 + typed "
        "[draining] (instant)"
    ),
    "serve.stream_detach": (
        "a resumable stream's channel died mid-flight: the stream parks "
        "in the detached-stream registry for the grace window, engine "
        "generation still running (instant; attrs carry token, sent "
        "offset, grace)"
    ),
    "serve.stream_resume": (
        "a parked stream was spliced onto a fresh channel at the "
        "proxy's delivered-byte offset via RES_RESUME (instant; attrs "
        "carry token, offset, epoch — the pair-closer of "
        "serve.stream_detach)"
    ),
    # -- engine ----------------------------------------------------------
    "engine.request": (
        "submit -> stream end for one generation (parent of the "
        "queue-wait/prefill/park spans)"
    ),
    "engine.queue_wait": (
        "submit -> decode-slot admission (the queueing half of the TTFT "
        "decomposition; engine_queue_wait_ms's per-request twin)"
    ),
    "engine.prefill_exec": (
        "slot admission -> first token, incl. any prefix-dedup park time "
        "(the execution half of the TTFT decomposition)"
    ),
    "engine.prefix_park": (
        "parked behind an in-flight shared-prefix prefill owned by "
        "another request (waiter side of prefix-grouped admission)"
    ),
    "engine.prefix_own": (
        "this request claimed shared-prefix blocks and will compute them "
        "for its group (owner side; instant, attrs carry the key count)"
    ),
    "engine.prefill_segment": (
        "one chunked-prefill sub-batch: dispatch -> sampled block on host "
        "(engine-scope; attrs carry the row count)"
    ),
    "engine.decode_burst": (
        "one multi-step decode burst: dispatch -> fetched block processed "
        "(engine-scope; overlaps its successor via pipelining)"
    ),
    "engine.first_token": "first token accounted for the request (instant)",
    "engine.stream_end": "the request's token stream finished (instant)",
    "engine.deadline_evict": (
        "the scheduler evicted the request at its deadline — queued or "
        "mid-decode (instant)"
    ),
    "engine.cold_compile": (
        "a program compiled ON the serving path after warmup completed — "
        "a hole in the warmup bucket grid; attrs carry the program key "
        "(instant; cold-start profiler)"
    ),
}

#: Optional trace-context request header: ``<trace_id>/<parent_span_id>``,
#: both lowercase hex.  Minted by the proxy when absent; forwarded verbatim
#: when recording is off so an upstream collector still sees one id.  A wire
#: convention like ``x-tunnel-deadline-ms`` (protocol.frames re-exports it).
TRACE_HEADER = "x-tunnel-trace"

_ids = itertools.count(1)


def mint_trace_id() -> str:
    """A fresh 32-hex-char trace id (random: unique across processes)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A process-unique span id.  Counter-based on purpose: span ids only
    need uniqueness within one recorder's journal, and a deterministic
    allocation keeps seeded chaos runs reproducible."""
    return f"{next(_ids):012x}"


@dataclass
class TraceContext:
    """Propagated trace context: the trace id plus the span id that any
    span created under this context should PARENT to."""

    trace_id: str
    span_id: str = ""

    def header_value(self) -> str:
        return f"{self.trace_id}/{self.span_id}"

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id)


def parse_trace_context(headers: Dict[str, str]) -> Optional[TraceContext]:
    """The request's ``x-tunnel-trace`` context, or None.

    Malformed values are ignored (None) — a bad trace hint must never fail
    a request that would otherwise succeed (the parse_deadline_ms rule).
    """
    for k, v in headers.items():
        if k.lower() != TRACE_HEADER:
            continue
        if not isinstance(v, str) or "/" not in v:
            return None
        tid, _, sid = v.partition("/")
        tid, sid = tid.strip(), sid.strip()
        if not tid or any(c not in "0123456789abcdef" for c in tid.lower()):
            return None
        return TraceContext(tid.lower(), sid)
    return None


@dataclass
class SpanRecord:
    """One journal entry.  ``dur`` is None for instant events.  ``ts`` and
    ``dur`` are ``time.monotonic()`` seconds — one clock domain per
    process, which is exactly the single-process proxy/serve stacks this
    repo runs; cross-process traces align per-track, not globally."""

    name: str
    trace_id: Optional[str]
    span_id: str
    parent_id: Optional[str]
    track: str
    ts: float
    dur: Optional[float]
    attrs: Dict[str, object] = field(default_factory=dict)


class TraceRecorder:
    """Bounded, thread-safe span journal with Chrome trace-event export."""

    def __init__(self, capacity: int = 4096, sample: float = 1.0,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self.capacity = max(1, capacity)
        self._records: Deque[SpanRecord] = deque(maxlen=self.capacity)
        # Engine-scope records (trace_id=None: decode bursts, prefill
        # segments) land in their OWN quarter-sized ring: they ignore the
        # sampling knob and fire every loop iteration, so sharing the
        # request ring would let the unsampled firehose evict exactly the
        # rare sampled request chains a low --trace-sample exists to keep.
        self._scope_records: Deque[SpanRecord] = deque(
            maxlen=max(1, self.capacity // 4)
        )
        self.sample = sample
        self.enabled = enabled

    def configure(self, *, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  sample: Optional[float] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self.capacity:
                self.capacity = max(1, capacity)
                self._records = deque(self._records, maxlen=self.capacity)
                self._scope_records = deque(
                    self._scope_records, maxlen=max(1, self.capacity // 4)
                )
            if sample is not None:
                self.sample = float(sample)
            if enabled is not None:
                self.enabled = bool(enabled)

    # -- recording decision ----------------------------------------------

    def on(self, trace_id: Optional[str]) -> bool:
        """Is this trace being recorded?  Deterministic per trace id, so
        every layer of one request reaches the same verdict independently.
        Engine-scope records (``trace_id=None``) follow ``enabled`` only.
        """
        if not self.enabled:
            return False
        if trace_id is None or self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        try:
            frac = int(trace_id[:8], 16) / float(0xFFFFFFFF)
        except ValueError:
            return True  # unhashable id: record rather than silently drop
        return frac < self.sample

    # -- emission ---------------------------------------------------------

    def add_span(
        self,
        name: str,
        *,
        trace_id: Optional[str],
        t0: float,
        t1: Optional[float] = None,
        span_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        track: str = "engine",
        attrs: Optional[Dict[str, object]] = None,
    ) -> Optional[str]:
        """Record one completed duration span; returns its span id, or
        None when the trace is not being recorded.  ``t0``/``t1`` are
        ``time.monotonic()`` instants captured by the caller (``t1``
        defaults to now)."""
        if not self.on(trace_id):
            return None
        sid = span_id or new_span_id()
        end = time.monotonic() if t1 is None else t1
        rec = SpanRecord(
            name=name, trace_id=trace_id, span_id=sid, parent_id=parent_id,
            track=track, ts=t0, dur=max(0.0, end - t0),
            attrs=dict(attrs or {}),
        )
        with self._lock:
            (self._records if trace_id is not None
             else self._scope_records).append(rec)
        return sid

    def add_event(
        self,
        name: str,
        *,
        trace_id: Optional[str],
        t: Optional[float] = None,
        parent_id: Optional[str] = None,
        track: str = "engine",
        attrs: Optional[Dict[str, object]] = None,
    ) -> Optional[str]:
        """Record one instant event (Chrome ``ph: "i"``)."""
        if not self.on(trace_id):
            return None
        sid = new_span_id()
        rec = SpanRecord(
            name=name, trace_id=trace_id, span_id=sid, parent_id=parent_id,
            track=track, ts=time.monotonic() if t is None else t, dur=None,
            attrs=dict(attrs or {}),
        )
        with self._lock:
            (self._records if trace_id is not None
             else self._scope_records).append(rec)
        return sid

    # -- reading ----------------------------------------------------------

    def records(self) -> List[SpanRecord]:
        """Both rings merged in timestamp order — one journal to readers."""
        with self._lock:
            merged = list(self._records) + list(self._scope_records)
        merged.sort(key=lambda r: r.ts)
        return merged

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._scope_records.clear()

    def chrome_trace(self) -> Dict[str, object]:
        """The journal as Chrome trace-event JSON (the object form:
        ``{"traceEvents": [...]}``) — loads in ``chrome://tracing`` /
        Perfetto.  Duration spans are ``ph: "X"`` complete events, instants
        ``ph: "i"``; tracks map to thread lanes with name metadata."""
        recs = self.records()
        tids: Dict[str, int] = {}
        events: List[Dict[str, object]] = []
        for rec in recs:
            tid = tids.setdefault(rec.track, len(tids) + 1)
            args: Dict[str, object] = dict(rec.attrs)
            if rec.trace_id is not None:
                args["trace_id"] = rec.trace_id
            args["span_id"] = rec.span_id
            if rec.parent_id:
                args["parent_id"] = rec.parent_id
            ev: Dict[str, object] = {
                "name": rec.name,
                "cat": rec.track,
                "pid": 1,
                "tid": tid,
                "ts": int(rec.ts * 1e6),
                "args": args,
            }
            if rec.dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = int(rec.dur * 1e6)
            events.append(ev)
        meta = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "p2p-llm-tunnel"}},
        ] + [
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
             "args": {"name": track}}
            for track, tid in tids.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def stitch_chrome_traces(
    sources: "Dict[str, Optional[dict]]",
) -> Dict[str, object]:
    """Merge per-process Chrome trace captures into ONE fleet trace with
    per-peer process lanes.

    ``sources`` maps a lane name (``"proxy"`` or a fabric peer id) to that
    process's ``/healthz?trace=1`` capture, or None for a stale source
    (scrape failed, peer dead).  Events are assigned to lanes:

    1. ``proxy``-track events belong to the proxy lane (the ingress
       process emitted them, whatever journal they were pulled from);
    2. ``serve``-track events carrying a ``peer`` attr (stamped from the
       Hello.peer handshake identity) belong to that peer's lane — this is
       what puts a failover's sibling ``serve.dispatch`` spans on TWO
       lanes under one trace id;
    3. everything else inherits its parent span's lane (the engine chain
       under a serve.dispatch), falling back to the journal it came from.

    Duplicate records — the same span pulled via several journals, which
    single-process loopback fabrics produce because every peer shares one
    recorder — are merged by identity ``(span_id, name, ph, ts, dur)``;
    cross-process captures whose counter-allocated span ids collide differ
    in ``ts`` and are correctly kept distinct.

    The result is a valid Chrome trace-event object (per-lane ``pid`` +
    ``process_name`` metadata) plus a ``stitch`` summary: the sources
    merged, the stale ones, and ``partial_traces`` — trace ids whose chain
    is incomplete (an orphaned ``parent_id``, or a ``proxy.request`` that
    names a serving peer contributing no spans: the peer's ring buffer
    evicted the trace, or the peer died unscraped).  Partial chains are
    FLAGGED, never an error — a fleet capture races eviction by design.
    """
    order = [s for s in sources if s == "proxy"] + sorted(
        s for s in sources if s != "proxy"
    )
    stale = [s for s in order if not isinstance(sources[s], dict)]

    # -- collect + dedupe -------------------------------------------------
    records: List[dict] = []  # each: {"ev": ..., "src": lane}
    seen: Dict[tuple, int] = {}
    for src in order:
        obj = sources[src]
        if not isinstance(obj, dict):
            continue
        for ev in obj.get("traceEvents", ()):
            if not isinstance(ev, dict) or ev.get("ph") == "M":
                continue
            args = ev.get("args", {})
            key = (args.get("span_id"), ev.get("name"), ev.get("ph"),
                   ev.get("ts"), ev.get("dur"))
            if key in seen:
                continue
            seen[key] = len(records)
            records.append({"ev": ev, "src": src})

    # -- lane assignment --------------------------------------------------
    span_lane: Dict[str, str] = {}
    lanes: Dict[int, Optional[str]] = {}
    for i, rec in enumerate(records):
        ev = rec["ev"]
        args = ev.get("args", {})
        lane: Optional[str] = None
        if ev.get("cat") == "proxy":
            lane = "proxy"
        elif ev.get("cat") == "serve" and args.get("peer"):
            lane = str(args["peer"])
        lanes[i] = lane
        if lane is not None and args.get("span_id"):
            span_lane[str(args["span_id"])] = lane
    for _pass in range(8):  # parent chains are short; bounded propagation
        changed = False
        for i, rec in enumerate(records):
            if lanes[i] is not None:
                continue
            parent = rec["ev"].get("args", {}).get("parent_id")
            if parent and str(parent) in span_lane:
                lanes[i] = span_lane[str(parent)]
                sid = rec["ev"].get("args", {}).get("span_id")
                if sid:
                    span_lane[str(sid)] = lanes[i]
                changed = True
        if not changed:
            break
    for i, rec in enumerate(records):
        if lanes[i] is None:
            lanes[i] = rec["src"]

    # -- partial-chain detection -----------------------------------------
    known_spans = {
        str(r["ev"]["args"]["span_id"])
        for r in records
        if r["ev"].get("args", {}).get("span_id")
    }
    trace_lanes: Dict[str, set] = {}
    for i, rec in enumerate(records):
        tid = rec["ev"].get("args", {}).get("trace_id")
        if tid:
            trace_lanes.setdefault(str(tid), set()).add(lanes[i])
    partial: set = set()
    for i, rec in enumerate(records):
        args = rec["ev"].get("args", {})
        tid = args.get("trace_id")
        if not tid:
            continue
        parent = args.get("parent_id")
        if (parent and str(parent) not in known_spans
                and rec["ev"].get("name") != "proxy.request"):
            # proxy.request may legitimately parent to an uncaptured
            # client-sent span; everything else orphaned = missing link.
            partial.add(str(tid))
        if (rec["ev"].get("name") == "proxy.request" and args.get("peer")
                and str(args["peer"]) not in trace_lanes.get(str(tid), ())):
            partial.add(str(tid))

    # -- emit with per-lane pids ------------------------------------------
    all_lanes = set(order) | {l for l in lanes.values() if l}
    lane_order = (["proxy"] if "proxy" in all_lanes else []) + sorted(
        all_lanes - {"proxy"}
    )
    pid_of = {lane: i + 1 for i, lane in enumerate(lane_order)}
    tids: Dict[tuple, int] = {}
    events: List[Dict[str, object]] = []
    for i, rec in enumerate(records):
        lane = lanes[i]
        ev = dict(rec["ev"])
        ev["pid"] = pid_of[lane]
        ev["tid"] = tids.setdefault(
            (lane, ev.get("cat", "")), len(
                [1 for (l, _c) in tids if l == lane]
            ) + 1,
        )
        events.append(ev)
    meta: List[Dict[str, object]] = []
    for lane in lane_order:
        name = lane if lane == "proxy" else f"peer:{lane}"
        if lane in stale:
            name += " (stale)"
        meta.append({"ph": "M", "name": "process_name",
                     "pid": pid_of[lane], "tid": 0, "args": {"name": name}})
    for (lane, cat), tid in tids.items():
        meta.append({"ph": "M", "name": "thread_name",
                     "pid": pid_of[lane], "tid": tid,
                     "args": {"name": cat or "events"}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "stitch": {
            "sources": order,
            "stale": stale,
            "partial_traces": sorted(partial),
        },
    }


def validate_chrome_trace(obj: object) -> bool:
    """Validate an exported trace against the Chrome trace-event schema
    subset this recorder emits; raises ValueError on the first problem.
    Used by the tier-1 schema test and by scripts/traceview.py before
    summarizing a capture."""
    if not isinstance(obj, dict) or not isinstance(
        obj.get("traceEvents"), list
    ):
        raise ValueError("trace must be an object with a traceEvents list")
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}")
        ph = ev["ph"]
        # "C" counter events are the flight recorder's numeric tracks
        #, merged into the same journal export.
        if ph not in ("X", "i", "M", "C"):
            raise ValueError(f"traceEvents[{i}] unknown phase {ph!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            raise ValueError(f"traceEvents[{i}] ts must be a non-negative "
                             "integer (microseconds)")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(
                    f"traceEvents[{i}] complete event needs an integer dur"
                )
        if not isinstance(ev.get("args", {}), dict):
            raise ValueError(f"traceEvents[{i}] args must be an object")
    json.dumps(obj)  # must be serializable as-is
    return True


#: Process-wide default recorder (disabled until configure(enabled=True) —
#: the serve/proxy ``--trace`` flag or a test fixture).
global_tracer = TraceRecorder(
    capacity=int(os.environ.get("TUNNEL_TRACE_BUFFER", "4096") or 4096),
)
