"""Engine flight recorder, compile/cold-start journal, postmortem black box.

The metrics registry answers AGGREGATE questions and the span journal
answers PER-REQUEST ones; neither answers *what did the engine loop decide
on iteration N* — which is exactly the question when goodput sags or the
decode-stall watchdog trips.  This module is that third leg:

- :class:`FlightRecorder` — a bounded, host-only, ALWAYS-ON ring holding
  one record per engine-loop iteration (mux budget inputs/outputs, decode
  burst width, prefill rows dispatched, slot/tenant occupancy, the host
  wall split).  Cheap enough to never be off: one dict + deque append per
  iteration, no device traffic, no syscalls.  Exported as Chrome-trace
  slice/counter tracks through the existing ``/healthz?trace=1`` journal
  (so the fleet stitching yields per-peer engine lanes for free) and
  summarized by ``scripts/traceview.py --flight``.
- :class:`CompileWatch` — the compile/cold-start journal: every compiled
  program emits one ``(program, key, shape, seconds, phase, cache_hit,
  cold)`` event.  A compile event AFTER warmup completed is a hole in the
  warmup bucket grid (the ``test_warmup_aot`` bug class) surfaced at
  runtime as ``engine_cold_compiles_total`` + a timeline event instead of
  only in tests.
- :class:`BlackBox` — postmortem capture: on a watchdog trip, SLO breach,
  drain timeout, or fatal engine error, atomically snapshot {flight tail,
  scheduler/slot/tenant state, recent spans, metrics, EngineConfig} into
  ONE schema-versioned JSON bundle, kept in a bounded in-memory ring
  (served at ``GET /healthz?postmortem=1``) and written under
  ``artifacts/`` when a directory is configured.

Every field name written into a flight record or a postmortem bundle must
be declared in :data:`FLIGHT_SCHEMA` / :data:`POSTMORTEM_SCHEMA` — the
TC06/TC09 catalog pattern, enforced statically by tunnelcheck rule TC16
and at runtime by :meth:`FlightRecorder.record_iteration` /
:meth:`BlackBox.capture`, so a typo'd field can never silently split the
black-box vocabulary between writers and the tools that read bundles.

Determinism contract: bundles captured at the same logical point of two
seeded chaos runs are identical after :func:`postmortem_canonical` strips
the explicitly-waived wall-clock fields (``WALLCLOCK_WAIVED`` + the
``_ms``/``_s`` suffix families) — pinned by tests/test_flight.py and the
``make chaos`` matrix row.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

log = get_logger(__name__)

#: The one catalogue of legal flight-record field names (tunnelcheck TC16).
#: One record per NON-IDLE engine-loop iteration; wall-clock fields are
#: waived from the postmortem determinism contract (see WALLCLOCK_WAIVED).
FLIGHT_SCHEMA: Dict[str, str] = {
    "iter": "engine-loop iteration sequence number (monotone per recorder)",
    "t": "monotonic instant the iteration started (s; wall-clock, waived)",
    "dur_ms": "host wall time of the whole iteration (waived)",
    "queue_depth": "requests in the scheduler waiting queue at admit time",
    "backlog_rows": (
        "prefill backlog in dispatch rows: remaining chunk segments + "
        "pending whole-prompt rows + parked prefix waiters"
    ),
    "min_slack_s": (
        "tightest deadline slack across queued/backlogged requests fed to "
        "the mux controller (None = no deadlines; wall-clock, waived)"
    ),
    "budget_tokens": (
        "the mux controller's chosen prefill token budget this iteration "
        "(0 when mux is off or nothing waited)"
    ),
    "admitted": "requests bound to decode slots this iteration",
    "prefill_rows": (
        "prefill rows actually dispatched this iteration (chunk segment "
        "rows + budgeted whole-prompt rows)"
    ),
    "decode_steps": "decode burst width dispatched (0 = no burst)",
    "decode_rows": "active rows in the dispatched decode burst",
    "active_slots": "occupied decode slots after admission",
    "tenants": "distinct tenants holding decode slots",
    "waiters": "requests parked behind an in-flight shared-prefix owner",
    "prefix_blocks_used": "prefix-pool blocks in use (0 when the pool is off)",
    "prefix_pages_reserved": (
        "pool pages reserved by admissions whose prompt insert has not "
        "landed yet (a nonzero steady state in a postmortem "
        "tail is a reservation leak)"
    ),
    "conv_inserted": (
        "finished conversations whose KV the end-of-iteration drain saved "
        "into the pool this iteration"
    ),
    "spill_pages": (
        "host-tier pages resident at iteration end (0 when the "
        "spill tier is off)"
    ),
    "spill_pageouts": (
        "pool pages the spill drain committed to the host tier this "
        "iteration"
    ),
    "spill_pageins": (
        "host-tier pages spliced back into the pool ahead of admission "
        "this iteration (the thrash detector's context — "
        "page-ins racing pageouts over a small window is the signature)"
    ),
    "pages_shipped": (
        "prefix-pool pages exported over the tunnel for KV_PAGES "
        "transfers since the last row (exports run off the "
        "iteration rhythm, drained into the next row)"
    ),
    "pages_spliced": (
        "wire-delivered KV pages spliced into the pool since the last "
        "row (the decode role's disagg hit signal)"
    ),
    "spec_proposed": (
        "draft tokens proposed to the fused verify burst this iteration "
        "(greedy rows only, 0 when speculation is off/idle)"
    ),
    "spec_accepted": (
        "proposed draft tokens the verify burst accepted this iteration "
        "(excludes the always-emitted bonus token)"
    ),
    "spec_k": (
        "burst width K the dispatched spec-verify program used this "
        "iteration (0 when no spec burst ran)"
    ),
    "cold_compiles": "mid-serve cold compiles detected during this iteration",
    "streams_detached": (
        "streams parked in the detached-stream registry's grace window "
        "at iteration end (nonzero while the engine is "
        "generating into replay journals with no channel attached)"
    ),
    "admit_ms": "expire + admission host wall (waived)",
    "prefill_ms": "prefill dispatch host wall (waived)",
    "dispatch_ms": "decode-burst dispatch host wall (waived)",
    "fetch_ms": "previous-burst device->host fetch wall (waived)",
    "process_ms": "token accounting + segment finish wall (waived)",
}

#: The one catalogue of legal postmortem-bundle top-level fields
#: (tunnelcheck TC16).  ``BlackBox.capture`` builds EXACTLY this key set —
#: a runtime lockstep guard backs the static rule.
POSTMORTEM_SCHEMA: Dict[str, str] = {
    "schema_version": "bundle schema version (int; bump on shape changes)",
    "trigger": (
        "what fired the capture: watchdog|slo|drain|crash|manual|memory"
    ),
    "attribution": (
        "where the engine was when the trigger fired — the flight "
        "recorder's current loop phase for watchdog/crash, the objective "
        "for slo, free text otherwise"
    ),
    "captured_unix_s": "wall-clock capture instant (waived)",
    "degraded": "the engine_degraded gauge at capture time (0/1)",
    "flight": "the last N flight records (FLIGHT_SCHEMA rows)",
    "compile_events": "the compile/cold-start journal (CompileWatch rows)",
    "spans": "recent span-journal records (empty when tracing is off)",
    "metrics": "full metrics snapshot (counters, gauges, histogram tails)",
    "slo": "per-objective SLO verdicts at capture time",
    "engine": (
        "the engine provider's state: EngineConfig, scheduler/slot/tenant "
        "snapshot, backlog registries, warmed-program set (null when no "
        "engine registered)"
    ),
}

POSTMORTEM_SCHEMA_VERSION = 1

#: Legal capture triggers.
POSTMORTEM_TRIGGERS = ("watchdog", "slo", "drain", "crash", "manual",
                       "memory")

#: Field NAMES excluded from the bundle-determinism contract: wall-clock
#: instants/durations and process-scoped ids.  Together with the
#: WALLCLOCK_SUFFIXES families, these are the ONLY fields two seeded chaos
#: runs may disagree on (tests/test_flight.py pins the rest byte-for-byte).
WALLCLOCK_WAIVED = frozenset({
    "captured_unix_s", "t", "ts", "dur", "seconds", "min_slack_s",
    "span_id", "parent_id", "trace_id",
})
#: Field-name suffixes waived as wall-clock derived (``engine_ttft_ms``,
#: ``engine_warmup_compile_s``, ``tenant_tokens_per_s``, ...); the
#: ``_ms_`` infix covers the registry's derived histogram keys
#: (``engine_ttft_ms_p50``...).
WALLCLOCK_SUFFIXES = ("_ms", "_s", "_per_s")


def _waived(key: str) -> bool:
    return (key in WALLCLOCK_WAIVED or key.endswith(WALLCLOCK_SUFFIXES)
            or "_ms_" in key or "_s_" in key)


def postmortem_canonical(obj: object) -> object:
    """The deterministic projection of a bundle: every waived wall-clock
    field removed, recursively.  Two seeded chaos runs' bundles must be
    EQUAL under this projection — the explicit waiver list is the whole
    escape hatch, so any new nondeterminism fails the identity test
    instead of quietly widening it."""
    if isinstance(obj, dict):
        return {
            k: postmortem_canonical(v)
            for k, v in obj.items()
            if not _waived(str(k))
        }
    if isinstance(obj, (list, tuple)):
        return [postmortem_canonical(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded, thread-safe, always-on ring of engine-loop iteration
    records, plus the loop's current-phase marker (what the watchdog
    reports as stall attribution)."""

    #: Chrome counter tracks exported per record (the rest of the fields
    #: ride the per-iteration slice's args).
    COUNTER_FIELDS = ("queue_depth", "backlog_rows", "budget_tokens",
                      "active_slots")

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(
                os.environ.get("TUNNEL_FLIGHT_RECORDS", "") or 1024
            )
        self._lock = threading.Lock()
        self.capacity = max(1, capacity)
        self._records: Deque[Dict[str, object]] = deque(maxlen=self.capacity)
        self._iter = 0
        self._phase = "idle"

    def configure(self, *, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self.capacity:
                self.capacity = max(1, capacity)
                self._records = deque(self._records, maxlen=self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._iter = 0
            self._phase = "idle"

    # -- phase marker ------------------------------------------------------

    def set_phase(self, phase: str) -> None:
        """Mark which loop phase is executing.  A wedged XLA dispatch
        leaves this at the stalled phase — the watchdog's attribution."""
        self._phase = phase

    def current_phase(self) -> str:
        return self._phase

    # -- recording ---------------------------------------------------------

    def record_iteration(self, **fields: object) -> None:
        """Append one iteration record.  Field names must come from
        FLIGHT_SCHEMA (the runtime twin of tunnelcheck TC16 — a typo'd
        field would otherwise silently split the black-box vocabulary);
        ``iter`` is assigned here."""
        unknown = set(fields) - set(FLIGHT_SCHEMA)
        if unknown:
            raise ValueError(
                f"flight-record field(s) not in FLIGHT_SCHEMA: "
                f"{sorted(unknown)}"
            )
        with self._lock:
            self._iter += 1
            rec = {"iter": self._iter}
            rec.update(fields)
            self._records.append(rec)
        global_metrics.inc("engine_flight_iterations_total")

    # -- reading -----------------------------------------------------------

    def records(self, last_n: Optional[int] = None) -> List[Dict[str, object]]:
        with self._lock:
            out = list(self._records)
        if last_n is not None:
            out = out[-last_n:]
        return [dict(r) for r in out]

    @property
    def iterations(self) -> int:
        return self._iter

    def chrome_events(self) -> List[Dict[str, object]]:
        """The ring as Chrome trace events: one ``ph:"X"`` slice per
        iteration on an ``engine-flight`` lane (args = the full record)
        plus ``ph:"C"`` counter tracks for the COUNTER_FIELDS series.
        Merged into the ``/healthz?trace=1`` export by the serve loop, so
        the fleet stitcher gives every peer its own engine-flight lane."""
        recs = self.records()
        events: List[Dict[str, object]] = []
        if not recs:
            return events
        tid = 1001  # clear of the recorder's small per-track tid space
        events.append({
            "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
            "args": {"name": "engine-flight"},
        })
        for rec in recs:
            t = float(rec.get("t", 0.0) or 0.0)
            dur_ms = float(rec.get("dur_ms", 0.0) or 0.0)
            ts = int(t * 1e6)
            events.append({
                "name": "engine.flight", "cat": "engine-flight",
                "ph": "X", "pid": 1, "tid": tid, "ts": ts,
                "dur": max(1, int(dur_ms * 1000)),
                "args": dict(rec),
            })
            for key in self.COUNTER_FIELDS:
                if key in rec:
                    events.append({
                        "name": f"flight.{key}", "cat": "engine-flight",
                        "ph": "C", "pid": 1, "tid": tid, "ts": ts,
                        "args": {key: rec[key]},
                    })
        return events


class CompileWatch:
    """Bounded, thread-safe journal of program-compile events.

    One event per (program kind, bucket shape) the FIRST time a process
    compiles/loads it: warmup's AOT phase, warmup's serial execute pass
    (``cache_hit`` when the AOT phase already compiled the key), and —
    the alarm case — ``cold=True`` mid-serve compiles after warmup
    declared the grid complete."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, object]] = deque(maxlen=max(1, capacity))
        self._seq = 0
        self._cold = 0

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._cold = 0

    def note(self, *, program: str, key: str, shape: List[int],
             seconds: float, phase: str, cache_hit: bool = False,
             cold: bool = False) -> None:
        with self._lock:
            self._seq += 1
            self._events.append({
                "seq": self._seq, "program": program, "key": key,
                "shape": list(shape), "seconds": round(seconds, 4),
                "phase": phase, "cache_hit": bool(cache_hit),
                "cold": bool(cold),
            })
            if cold:
                self._cold += 1

    def mark(self) -> int:
        """Current sequence number — pass to :meth:`since` to read only
        events recorded after this point (one engine's warmup)."""
        with self._lock:
            return self._seq

    def since(self, mark: int) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > mark]

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(e) for e in self._events]

    @property
    def cold_total(self) -> int:
        return self._cold


class BlackBox:
    """Postmortem bundle capture + bounded in-memory store + archive dir.

    ``capture`` assembles EXACTLY the POSTMORTEM_SCHEMA key set from the
    process-global observability state (flight ring, compile journal,
    span journal, metrics registry, SLO verdicts) plus the registered
    engine provider, stores the bundle in a small ring (served at
    ``GET /healthz?postmortem=1``), and — when a directory is configured
    (``TUNNEL_POSTMORTEM_DIR`` / serve ``--postmortem-dir``) — writes it
    atomically (tmp + rename) as one JSON file."""

    #: Bundles kept in memory; flight tail length embedded per bundle.
    STORE_CAP = 8
    FLIGHT_TAIL = 256

    def __init__(self, directory: Optional[str] = None):
        if directory is None:
            directory = os.environ.get("TUNNEL_POSTMORTEM_DIR", "")
        self._lock = threading.Lock()
        self.directory = directory or ""
        self._bundles: Deque[Dict[str, object]] = deque(maxlen=self.STORE_CAP)
        self._paths: List[str] = []
        self._seq = 0
        self._capturing = False
        self._engine_provider: Optional[Callable[[], Optional[dict]]] = None
        #: Outstanding archive-writer threads (non-daemon, bounded work).
        self._writers: List[threading.Thread] = []

    def configure(self, *, directory: Optional[str] = None) -> None:
        with self._lock:
            if directory is not None:
                self.directory = directory

    def reset(self) -> None:
        with self._lock:
            self._bundles.clear()
            self._paths.clear()
            self._seq = 0
            self._engine_provider = None

    def set_engine_provider(
        self, fn: Optional[Callable[[], Optional[dict]]]
    ) -> None:
        """Register the engine-state contributor (latest engine wins —
        one serving engine per process is the deployed shape)."""
        with self._lock:
            self._engine_provider = fn

    # -- capture -----------------------------------------------------------

    def capture(self, trigger: str, attribution: Optional[str] = None,
                slo: Optional[dict] = None,
                extra: Optional[dict] = None) -> Optional[dict]:
        """Snapshot the black box.  Returns the bundle, or None when a
        capture is already in progress (re-entrancy guard: an SLO publish
        inside a capture must not recurse into a second capture) or the
        assembly itself failed.

        ``extra`` merges declared POSTMORTEM_SCHEMA fields over the
        assembled defaults (tunnelcheck TC16 checks literal keys; the
        drift guard below rejects undeclared ones at runtime).

        NEVER raises past the unknown-trigger precondition: every caller
        sits on an incident path (a crash handler, the watchdog, a drain
        that already blew its budget) where a diagnostics failure
        preempting the actual failure handling would be strictly worse
        than a missing bundle — assembly errors log loudly and return
        None instead."""
        if trigger not in POSTMORTEM_TRIGGERS:
            raise ValueError(f"unknown postmortem trigger {trigger!r}")
        with self._lock:
            if self._capturing:
                return None
            self._capturing = True
            provider = self._engine_provider
        try:
            return self._capture_inner(
                trigger, attribution, slo, extra, provider
            )
        except Exception:
            log.exception(
                "postmortem capture failed (trigger=%s); the incident "
                "path continues without a bundle", trigger,
            )
            return None
        finally:
            with self._lock:
                self._capturing = False

    def _capture_inner(self, trigger, attribution, slo, extra,
                       provider) -> dict:
        if slo is None:
            from p2p_llm_tunnel_tpu_torch.utils.slo import global_slo

            slo = global_slo.section()
        engine_state = None
        if provider is not None:
            try:
                engine_state = provider()
            except Exception as e:  # a torn engine must not block capture
                engine_state = {"provider_error": str(e)}
        from p2p_llm_tunnel_tpu_torch.utils.tracing import global_tracer

        bundle: Dict[str, object] = {
            "schema_version": POSTMORTEM_SCHEMA_VERSION,
            "trigger": trigger,
            "attribution": attribution,
            "captured_unix_s": round(time.time(), 3),
            "degraded": global_metrics.gauge("engine_degraded"),
            "flight": global_flight.records(last_n=self.FLIGHT_TAIL),
            "compile_events": global_compile_watch.events(),
            "spans": [
                {
                    "name": r.name, "trace_id": r.trace_id,
                    "span_id": r.span_id, "parent_id": r.parent_id,
                    "track": r.track, "ts": r.ts, "dur": r.dur,
                    "attrs": dict(r.attrs),
                }
                for r in global_tracer.records()
            ],
            "metrics": global_metrics.snapshot(),
            "slo": slo,
            "engine": engine_state,
        }
        bundle.update(extra or {})
        # Runtime lockstep with the declared schema (the static half is
        # tunnelcheck TC16): the builder above — and any extra= keys —
        # must match POSTMORTEM_SCHEMA exactly, loudly (the raise is
        # absorbed by capture()'s never-break-serving guard but lands in
        # the log and fails the schema tests).
        drift = set(bundle).symmetric_difference(POSTMORTEM_SCHEMA)
        if drift:
            raise RuntimeError(
                f"postmortem bundle schema drift: {sorted(drift)}"
            )
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._bundles.append(bundle)
            directory = self.directory
        global_metrics.inc("engine_postmortems_total")
        log.error(
            "postmortem captured: trigger=%s attribution=%s "
            "(%d flight records, %d compile events)",
            trigger, attribution, len(bundle["flight"]),
            len(bundle["compile_events"]),
        )
        if directory:
            # Archive off the caller's thread: the SLO-edge capture runs
            # on the serving event loop, and a multi-MB json.dump to disk
            # there would stall every tunnel stream at exactly the moment
            # the SLO is burning.  NON-daemon so a process exiting right
            # after an incident (the chaos gate, a crashing serve) still
            # finishes the one bounded write; flush() joins explicitly.
            t = threading.Thread(
                target=self._write, args=(bundle, directory, seq),
                name="postmortem-write",
            )
            with self._lock:
                self._writers = [w for w in self._writers if w.is_alive()]
                self._writers.append(t)
            t.start()
        return bundle

    def flush(self, timeout: float = 10.0) -> None:
        """Join outstanding archive writes (tests, pre-exit hooks)."""
        with self._lock:
            writers = list(self._writers)
        for t in writers:
            t.join(timeout)

    def _write(self, bundle: dict, directory: str, seq: int) -> None:
        """Atomic archive write: a reader (the chaos summary, an operator
        tailing artifacts/) never sees a torn bundle."""
        try:
            os.makedirs(directory, exist_ok=True)
            name = f"postmortem-{bundle['trigger']}-{os.getpid()}-{seq:03d}.json"
            path = os.path.join(directory, name)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, indent=1, default=str)
            os.replace(tmp, path)
            with self._lock:
                self._paths.append(path)
            log.error("postmortem bundle written to %s", path)
        except OSError as e:
            log.warning("postmortem bundle write failed: %s", e)

    def section(self) -> Dict[str, object]:
        """The ``/healthz?postmortem=1`` payload — ONE builder shared by
        the serve loop and the proxy's fleet federation, so the federated
        ``proxy`` entry can never drift from the per-peer entries."""
        return {
            "postmortem": self.last(),
            "captured": self.captured,
            "paths": self.paths(),
        }

    # -- reading -----------------------------------------------------------

    def last(self) -> Optional[dict]:
        with self._lock:
            return dict(self._bundles[-1]) if self._bundles else None

    def bundles(self) -> List[dict]:
        with self._lock:
            return [dict(b) for b in self._bundles]

    def paths(self) -> List[str]:
        with self._lock:
            return list(self._paths)

    @property
    def captured(self) -> int:
        with self._lock:
            return self._seq


#: Process-wide singletons (the global_metrics/global_tracer convention).
global_flight = FlightRecorder()
global_compile_watch = CompileWatch()
global_blackbox = BlackBox()


def _slo_alert(objective: str, state: str, verdicts: dict) -> None:
    """SLO transition hook: an objective entering burning/breached is a
    black-box trigger — the bundle's attribution names the objective."""
    global_blackbox.capture(
        "slo", attribution=f"{objective}:{state}", slo=verdicts,
    )


# Wire the SLO engine's worsening-transition hook once per process: any
# module importing flight (the engine, the serve loop) arms postmortem
# capture on SLO breach without its own wiring.  capture() is re-entrancy
# guarded, so a publish inside a capture cannot recurse.
from p2p_llm_tunnel_tpu_torch.utils.slo import global_slo as _global_slo  # noqa: E402

_global_slo.on_alert = _slo_alert
