"""First-class observability counters.

The reference has logging only — no counters, no /metrics (SURVEY.md §5).
This framework exposes the BASELINE-graded quantities (tok/s, TTFT, queue
depth, batch occupancy) as a tiny in-process registry that endpoints, the
engine, and ``bench.py`` all share.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Tuple

#: The one catalogue of legal metric names.  Every literal string handed to
#: ``Metrics.inc``/``set_gauge``/``observe`` (and the read-side ``counter``/
#: ``gauge``/``percentile``/``rate``, which /healthz and bench.py use) must
#: appear here — enforced statically by tunnelcheck rule TC06, so a typo'd
#: name can't silently split a time series.  ``snapshot()`` derives
#: ``<hist>_p50``/``_p95``/``_p99``/``_p999``/``_count`` suffixes from
#: histogram names; those derived keys are intentionally not catalogued.
METRICS_CATALOG: Dict[str, str] = {
    # -- engine ----------------------------------------------------------
    "engine_tokens_total": "decode tokens emitted to streams (counter)",
    "engine_prefill_tokens_total": "prompt tokens prefilled (counter)",
    "engine_prefill_segments_total": "chunked-prefill segments executed (counter)",
    "engine_spec_tokens_total": "tokens emitted via speculative decode (counter)",
    "engine_spec_accepted_tokens_total": "draft tokens accepted by verify (counter)",
    "engine_spec_proposed_tokens_total": (
        "draft tokens proposed to verify bursts across greedy rows "
        "(counter; accepted/proposed is the lifetime acceptance rate)"
    ),
    "engine_spec_accept_rate": (
        "verify acceptance rate over the last 64 bursts (gauge; the "
        "windowed signal behind per-slot adaptive K)"
    ),
    "engine_spec_hist_entries": (
        "live per-slot spec proposer histories (gauge; must return to 0 "
        "when no requests are active — the leak gate loadgen "
        "asserts post-run)"
    ),
    "engine_prefix_hit_tokens_total": "prompt tokens served from prefix cache (counter)",
    "engine_prefix_saved_blocks_total": "KV blocks saved into prefix cache (counter)",
    "engine_prefix_dedup_hits_total": (
        "admissions parked behind an in-flight shared-prefix prefill "
        "instead of recomputing it (counter; prefix-grouped "
        "admission)"
    ),
    "engine_mux_budget_tokens": (
        "per-iteration prefill token budget picked by the multiplexing "
        "controller (gauge; 0 when idle or mux off)"
    ),
    "engine_deadline_timeouts_total": "requests evicted at their deadline (counter)",
    "engine_watchdog_stalls_total": "decode-stall watchdog trips (counter)",
    "engine_queue_depth": "requests waiting for a slot (gauge)",
    "engine_batch_occupancy": "fraction of decode slots occupied (gauge)",
    "engine_degraded": "1 while the decode watchdog deems the engine stalled (gauge)",
    "engine_decode_kernels_per_step": (
        "kernel roots (products, scatters/gathers, sorts, hand-written "
        "kernels) per decode layer-step of a parked eager burst, counted "
        "at dispatch after warmup (gauge; utils/launch_count.py)"
    ),
    "engine_warmup_compile_s": (
        "wall seconds warmup spent compiling the serving program set "
        "(gauge; the number a chip window must fit before serving)"
    ),
    # -- engine flight recorder / warmup ----------
    "engine_warmup_programs": (
        "warm dispatches warmup ran before serving, one per program kind "
        "(decode, spec when on, prefill): eager PyTorch compiles nothing "
        "per shape (gauge)"
    ),
    "engine_warmup_compile_max_s": (
        "wall seconds of the slowest warmup step: the kernel build, a "
        "warm dispatch or the launch count (gauge; at most "
        "engine_warmup_compile_s)"
    ),
    "engine_flight_iterations_total": (
        "engine-loop iterations recorded by the flight recorder (counter; "
        "exactly one flight-ring record each — the recorder's overhead "
        "and coverage invariant)"
    ),
    "engine_postmortems_total": (
        "postmortem black-box bundles captured (counter; triggers: "
        "watchdog trip, SLO breach, drain timeout, engine crash)"
    ),
    "engine_ttft_ms": "time to first token per request (histogram, ms)",
    "engine_queue_wait_ms": (
        "submit -> decode-slot admission wait per request (histogram, ms; "
        "the queueing half of the TTFT decomposition)"
    ),
    "engine_prefill_exec_ms": (
        "slot admission -> first token per request (histogram, ms; the "
        "execution half of the TTFT decomposition, incl. prefix-dedup "
        "park time)"
    ),
    "engine_prefill_ms": "prefill step latency (histogram, ms)",
    "engine_decode_fetch_ms": "device->host fetch of a sampled block (histogram, ms)",
    # -- serve endpoint --------------------------------------------------
    "serve_requests_total": "tunneled requests dispatched to the backend (counter)",
    "serve_timeouts_total": "requests cut by x-tunnel-deadline-ms (counter)",
    "serve_upstream_errors_total": "backend failures before headers (counter)",
    "serve_shed_total": "requests shed by admission control or drain (counter)",
    # -- mid-stream continuity --------------------------------
    "serve_stream_resumes_total": (
        "parked streams spliced onto a fresh channel by RES_RESUME "
        "(counter; one per successful mid-stream reattach — the chaos "
        "proof asserts exactly 1 under a seeded kill)"
    ),
    "serve_streams_detached": (
        "streams currently parked in the detached-stream registry's "
        "grace window — channel died, engine generation still running, "
        "replay journal still filling (gauge; nonzero after every client "
        "finished is a leak)"
    ),
    "serve_replay_buffer_bytes": (
        "resident response bytes across every replay journal (gauge; "
        "bounded per stream by --stream-journal-bytes — the memory cost "
        "of resumability, and the journal bound the bw= chaos row "
        "asserts under a lagging client)"
    ),
    "proxy_stream_resume_ms": (
        "mid-stream link death -> RES_RESUMED accepted on a recovered "
        "peer, for streams that reattached instead of surfacing the "
        "typed peer_lost terminal (histogram, ms)"
    ),
    # -- proxy endpoint --------------------------------------------------
    "proxy_requests_total": "HTTP requests entering the tunnel (counter)",
    "proxy_body_bytes_total": "response body bytes relayed to clients (counter)",
    "proxy_streams_in_flight": "open tunnel streams (gauge)",
    "proxy_ttfb_ms": "first response byte per proxied request (histogram, ms)",
    # -- multi-peer fabric -------------------------------------
    "proxy_peers_live": (
        "serve peers currently dispatchable (live + degraded) in the "
        "proxy's PeerSet (gauge; 0 means every request 503s)"
    ),
    "proxy_failover_ms": (
        "peer-death -> re-dispatched request streaming again on a "
        "surviving peer (histogram, ms; the measured recovery time of a "
        "failover, one sample per re-dispatched request)"
    ),
    "proxy_redispatch_total": (
        "requests transparently re-dispatched to a surviving peer after "
        "their serve peer died before streaming (counter)"
    ),
    "proxy_circuit_open_total": (
        "per-peer circuit-breaker openings after consecutive dispatch "
        "failures (counter; an open breaker sheds dispatches until its "
        "half-open probe succeeds)"
    ),
    # -- transport -------------------------------------------------------
    "transport_cwnd": "ARQ congestion window, packets (gauge)",
    "transport_in_flight": "unacked ARQ packets (gauge)",
    "transport_srtt_ms": "smoothed RTT of the ARQ path (gauge, ms)",
    "transport_retransmits_total": "ARQ retransmissions (counter)",
    # -- per-tenant ingress accounting --------------------------
    # The tenant_* names render as LABELED series ({tenant="..."}) in the
    # Prometheus exposition and as the /healthz "tenants" section; they are
    # written through the registry's tenant_* methods, never inc/set_gauge.
    "tenant_in_flight": (
        "concurrently generating requests per tenant (gauge, labeled "
        "{tenant})"
    ),
    "tenant_requests_total": (
        "generation requests begun per tenant (counter, labeled {tenant})"
    ),
    "tenant_tokens_total": (
        "decode tokens emitted per tenant (counter, labeled {tenant})"
    ),
    "tenant_tokens_per_s": (
        "sliding-window decode token rate per tenant (gauge, labeled "
        "{tenant}; the consumption signal behind weighted-fair admission)"
    ),
    "tenant_sheds_total": (
        "requests shed by tenant-fair admission per tenant (counter, "
        "labeled {tenant})"
    ),
    "engine_tenant_sheds_total": (
        "requests shed by tenant-fair admission, all tenants (counter; "
        "per-tenant split in the tenant_sheds_total labeled series)"
    ),
    "engine_admissions_total": (
        "requests admitted into decode slots (counter; the drain-rate "
        "numerator behind the derived Retry-After)"
    ),
    "engine_retry_after_s": (
        "advisory Retry-After the engine API last attached to a 429 "
        "(gauge, s; queue depth / admission drain rate, clamped to "
        "[1, 60])"
    ),
    "serve_retry_after_s": (
        "advisory Retry-After the serve loop last attached to a 429 "
        "(gauge, s; in-flight count / dispatch rate, clamped to [1, 60])"
    ),
    # -- prefix pool (/healthz memory accounting) ----------------
    "engine_prefix_pool_blocks_used": (
        "prefix-cache pool blocks holding cached prompt KV (gauge; "
        "capacity minus free minus the scratch block)"
    ),
    "engine_prefix_pool_blocks_free": (
        "prefix-cache pool blocks available for insertion (gauge)"
    ),
    "engine_prefix_pool_kv_bytes": (
        "resident KV bytes of used prefix-pool blocks (gauge; reflects the "
        "kv_quant mode — int8/int4 pools store proportionally fewer bytes "
        "per block)"
    ),
    # -- block-paged pool + conversation cache -----------------
    "engine_prefix_pool_pages_reserved": (
        "pool pages reserved by admissions whose prompt insert has not "
        "landed yet (gauge; nonzero after every stream finished is a "
        "reservation leak — the test_paged_pool leak-gate invariant)"
    ),
    "engine_prefix_evictions_total": (
        "pool pages evicted to make room (counter; cost-aware GreedyDual "
        "by default — pages weigh their full-prefix recompute cost, "
        "tokens x live per-token prefill ms)"
    ),
    "engine_conv_saved_pages_total": (
        "conversation-cache pages saved from finished streams' KV — "
        "prompt AND generated tokens (counter; also counted in "
        "engine_prefix_saved_blocks_total)"
    ),
    "engine_conv_hits_total": (
        "admissions whose prefix match reached into conversation-cache "
        "pages — a returning user's history reused (counter)"
    ),
    "engine_conv_hit_tokens_total": (
        "prompt tokens served from conversation-cache pages instead of "
        "re-prefilling a resent history (counter; the multi-turn "
        "re-prefill saving, turn-2+ prefills tail-only)"
    ),
    # -- KV spill tier + memory degradation contract -----------
    "engine_spill_pages": (
        "KV pages resident in the host-RAM spill tier — shadows of "
        "HBM-resident pages plus host-only migrated pages (gauge; 0 when "
        "the tier is off)"
    ),
    "engine_spill_bytes": (
        "host RAM held by spill-tier pages (gauge; pages x per-page KV "
        "bytes, reflecting the kv_quant mode like "
        "engine_prefix_pool_kv_bytes)"
    ),
    "engine_spill_inflight": (
        "tier I/O operations planned but not yet committed — page-outs "
        "copying on the executor plus page-in slot claims awaiting "
        "verification (gauge; nonzero after drain is an I/O leak — the "
        "loadgen leak-gate invariant)"
    ),
    "engine_spill_pageouts_total": (
        "cold pool pages copied out to the host tier (counter; cost-ranked "
        "by GreedyDual priority, batched off the serving path)"
    ),
    "engine_spill_pageins_total": (
        "host-tier pages spliced back into the pool ahead of an admission "
        "whose prompt chain continues into the tier (counter; the tier's "
        "hit signal — rate against pageouts for tier efficiency)"
    ),
    "engine_spill_pageout_failures_total": (
        "page-outs that failed mid-copy (counter; chaos fail/stall paths "
        "included — the page simply stays HBM-only, nothing is lost)"
    ),
    "engine_spill_pagein_failures_total": (
        "page-ins dropped by the integrity checksum, compatibility pin "
        "check, or I/O failure (counter; each one fell back to tail "
        "re-prefill — correctness never depends on the tier)"
    ),
    "engine_spill_pageout_ms": (
        "per-batch page-out migration latency, device gather + host copy "
        "(histogram, ms)"
    ),
    "engine_spill_pagein_ms": (
        "per-batch page-in migration latency, verify + device scatter "
        "(histogram, ms)"
    ),
    "engine_thrash_trips_total": (
        "memory-thrash detector trips: eviction-and-realloc rate over the "
        "detector window crossed the threshold, flipping engine_degraded "
        "with engine_degraded_reason=memory and capturing a postmortem "
        "bundle (counter)"
    ),
    "engine_memory_shed_total": (
        "admissions shed with the typed `memory` verdict: HBM pool fully "
        "reserved AND spill tier at capacity (counter; the 429 + "
        "Retry-After degradation contract — never thrash)"
    ),
    # -- disaggregated prefill/decode ---------------------------
    "engine_pages_shipped_total": (
        "prefix-pool pages exported over the tunnel to a decode peer "
        "(counter; incremented by the prefill role's KV_PAGES export "
        "path after the pin self-check passes)"
    ),
    "engine_pages_spliced_total": (
        "wire-delivered KV pages spliced into this pool through the "
        "two-phase verify path (counter; the decode role's disagg hit "
        "signal — rate against shipped for transfer efficiency)"
    ),
    "engine_page_xfer_bytes_total": (
        "page payload bytes exported for KV_PAGES transfers (counter; "
        "kv_quant-scaled — int4 pools ship a quarter of the none-mode "
        "bytes for the same tokens)"
    ),
    "engine_page_refusals_total": (
        "wire pages refused by the pin check or integrity checksum "
        "(counter; each refusal fell back to local re-prefill — "
        "disaggregation is an optimization, never a failure mode)"
    ),
    "engine_page_export_ms": (
        "per-transfer export latency, device gather + pin self-check + "
        "checksum + serialization (histogram, ms)"
    ),
    "engine_kv_xfer_inflight": (
        "KV page transfers (exports + imports) currently on the "
        "executor (gauge; nonzero after drain is a transfer leak — the "
        "loadgen leak-gate invariant, like engine_spill_inflight)"
    ),
    "proxy_affinity_hits_total": (
        "dispatches where prefix-affinity routing (rendezvous hash on "
        "the request's prefix chain key) landed the request on its "
        "affine peer (counter; health/breaker state overrides affinity, "
        "so misses under churn are expected, not bugs)"
    ),
    "proxy_disagg_handoffs_total": (
        "requests whose KV pages were prefetched from a prefill peer "
        "and shipped to the decode peer before dispatch (counter)"
    ),
    "proxy_disagg_fallbacks_total": (
        "disagg handoffs abandoned mid-flight — prefill peer died, "
        "refused, or timed out — where the request was dispatched "
        "anyway for local re-prefill (counter; the chaos row's "
        "fallback-not-failure signal)"
    ),
    # -- fleet observability plane ------------------------------
    # The fleet_* names live in the PROXY process: aggregates over its
    # PeerSet, refreshed by /metrics?fleet=1 scrapes and the PeerSet's
    # gauge publishing.  Serve peers render them zero-valued (full-catalog
    # contract) and the federation merger drops them from the per-peer
    # relabeled sections, so the fleet exposition carries exactly one copy.
    "fleet_peers_live": (
        "serve peers currently dispatchable (live + degraded) in the "
        "proxy's PeerSet (gauge; the fleet twin of proxy_peers_live, "
        "refreshed alongside the fleet aggregates)"
    ),
    "fleet_peers_degraded": (
        "serve peers in the degraded routing state — dispatchable only "
        "when no live peer exists (gauge)"
    ),
    "fleet_streams_in_flight": (
        "tunnel streams open across every peer at the last fleet "
        "snapshot (gauge)"
    ),
    "fleet_sheds_summed": (
        "serve_shed_total + engine_tenant_sheds_total summed per peer at "
        "the last /metrics?fleet=1, with a STALE peer carrying its "
        "last-known value until it leaves the scrape set (gauge; rate() "
        "this for the fleet-wide shed rate — a transient scrape timeout "
        "never dips the sum, so it is monotone while the peer set is "
        "stable)"
    ),
    "fleet_redispatch_per_s": (
        "sliding-window rate of proxy_redispatch_total at the last fleet "
        "snapshot (gauge; the fleet-wide failover pressure signal)"
    ),
    "fleet_peer_scrape_stale": (
        "1 when the peer's last fleet scrape failed, timed out, or the "
        "peer recently died — its series in the federated exposition are "
        "absent or stale, never silently zero (gauge, labeled {peer}; 0 "
        "for freshly-scraped peers)"
    ),
    # -- SLO burn-rate engine (utils/slo.py) ---------------------
    "slo_burn_fast": (
        "error-budget burn rate over the fast (~5 min) window per "
        "objective: error rate divided by the objective's budget, 1.0 = "
        "consuming exactly the sustainable budget (gauge, labeled "
        "{objective})"
    ),
    "slo_burn_slow": (
        "error-budget burn rate over the slow (~1 h) window per "
        "objective (gauge, labeled {objective}; the sustained-violation "
        "signal behind the breached verdict)"
    ),
    "slo_state": (
        "objective verdict: 0 ok, 1 burning (fast window consuming "
        "budget at >= the alert threshold), 2 breached (slow window "
        "too) (gauge, labeled {objective}; burning wires into the "
        "/healthz degraded signal)"
    ),
}

#: Default reservoir size per histogram.  Sized for tail quantiles: p999
#: needs ~1000+ samples AFTER the keep-recent halving, so the floor the
#: reservoir can drop to (cap/2) must stay comfortably above that.  The
#: pre-ISSUE-6 cap of 4096 could not support p999 claims right after a
#: halving; override per-registry or via TUNNEL_METRICS_RESERVOIR.
DEFAULT_RESERVOIR = 16384


def nearest_rank(values: List[float], p: float) -> float:
    """Nearest-rank percentile ``p`` (0–100) over an unsorted list; 0.0
    when empty.  The ONE estimator shared by the registry reservoirs,
    bench herd rows, and scripts/traceview.py — a fix applied here cannot
    diverge the three tails from each other."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[idx]


#: Ceiling on distinct tenants the registry tracks.  At the cap, a new
#: tenant evicts the least-recently-active idle one; if every tracked
#: tenant is mid-flight, overflow lumps into the "~other" bucket — per-key
#: accounting must never become an unbounded-memory vector for an
#: adversary minting API keys.
TENANT_CAP = 512
#: Aggregation bucket for tenants beyond TENANT_CAP.
TENANT_OVERFLOW = "~other"

#: Ceiling on distinct label values per labeled-gauge family (the
#: fleet/slo ``{peer=...}`` / ``{objective=...}`` series).  At the cap the
#: least-recently-set label is evicted — same rationale as TENANT_CAP:
#: per-label accounting must never be an unbounded-cardinality vector
#: (tunnelcheck TC12 exists so NO labeled series is ever produced outside
#: these bounded helpers).
LABELED_CAP = 256


def prom_label_escape(v: str) -> str:
    """Escape a label VALUE for the Prometheus text exposition."""
    return v.replace("\\", "\\\\").replace('"', '\\"')


def prom_sample(name: str, labels: "Dict[str, str]", value: float) -> str:
    """One exposition sample line with properly-escaped labels — the ONE
    place label syntax is interpolated (tunnelcheck TC12 forbids hand-
    rolled ``{key="..."}`` f-strings everywhere outside this module)."""
    if not labels:
        return f"{name} {value:.6g}"
    inner = ",".join(
        f'{k}="{prom_label_escape(str(v))}"' for k, v in labels.items()
    )
    return f"{name}{{{inner}}} {value:.6g}"


class _TenantStats:
    """One tenant's ingress accounting (mutated under the registry lock)."""

    __slots__ = ("in_flight", "requests", "sheds", "tokens", "samples",
                 "last")

    def __init__(self) -> None:
        self.in_flight = 0
        self.requests = 0.0
        self.sheds = 0.0
        self.tokens = 0.0
        #: (time, cumulative tokens) samples taken at read time — the
        #: same sliding-window scheme as Metrics.rate().
        self.samples: Deque[Tuple[float, float]] = deque()
        self.last = 0.0


class _Percentiles:
    """Bounded reservoir of observations with percentile queries."""

    def __init__(self, cap: int = DEFAULT_RESERVOIR):
        if cap < 2:
            raise ValueError("reservoir cap must be >= 2")
        self._cap = cap
        self._values: List[float] = []

    def observe(self, v: float) -> None:
        if len(self._values) >= self._cap:
            # Drop the oldest half to stay bounded while keeping recency.
            self._values = self._values[self._cap // 2 :]
        self._values.append(v)

    def percentile(self, p: float) -> float:
        return nearest_rank(self._values, p)

    def percentiles(self, ps) -> List[float]:
        """Several quantiles from ONE sort — snapshot()/prometheus_text()
        read 4-5 quantiles per histogram while holding the registry lock
        the per-token hot path contends on, so the sort must not repeat
        per quantile."""
        if not self._values:
            return [0.0] * len(ps)
        xs = sorted(self._values)
        n = len(xs)
        return [
            xs[min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))]
            for p in ps
        ]

    @property
    def count(self) -> int:
        return len(self._values)


class Metrics:
    """Thread-safe registry of counters, gauges, and latency histograms.

    ``hist_cap`` sizes every histogram's reservoir (default
    DEFAULT_RESERVOIR, overridable process-wide via the
    ``TUNNEL_METRICS_RESERVOIR`` env var) — the knob that decides which
    tail quantiles the registry can honestly report.
    """

    def __init__(self, hist_cap: Optional[int] = None) -> None:
        if hist_cap is None:
            hist_cap = int(
                os.environ.get("TUNNEL_METRICS_RESERVOIR", "")
                or DEFAULT_RESERVOIR
            )
        if hist_cap < 2:
            # Validated HERE, not lazily in the defaultdict factory: a bad
            # TUNNEL_METRICS_RESERVOIR must fail at construction, not at
            # the first observe() deep inside the serving path.
            raise ValueError("hist_cap (reservoir size) must be >= 2")
        self._hist_cap = hist_cap
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Percentiles] = defaultdict(
            lambda: _Percentiles(self._hist_cap)
        )
        #: Per-counter (time, value) samples taken at rate() reads — the
        #: sliding-window rate state (see rate()).
        self._rate_hist: Dict[str, Deque[Tuple[float, float]]] = {}
        #: Per-tenant ingress accounting, bounded at TENANT_CAP.
        self._tenants: Dict[str, _TenantStats] = {}
        #: Labeled-gauge families: name -> (label key,
        #: {label value: (gauge value, last-set time)}), bounded at
        #: LABELED_CAP labels per family.
        self._labeled: Dict[str, Tuple[str, Dict[str, Tuple[float, float]]]] = {}
        #: Structured CONFIGURATION facts (the composition-fence
        #: registry) published by the engine for /healthz to read without
        #: an engine reference.  Not measurements: reset() keeps them —
        #: wiping the fence list on a metrics reset would report a fenced
        #: engine as unfenced.
        self._info: Dict[str, object] = {}
        self._t0 = time.monotonic()

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += amount

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists[name].observe(value)

    def set_labeled_gauge(self, name: str, key: str, label: str,
                          value: float) -> None:
        """Set one sample of a labeled-gauge family (``name{key="label"}``).

        THE bounded write path for labeled series (tunnelcheck TC12): at
        LABELED_CAP distinct labels per family, the least-recently-set
        label is evicted, so adversarial label minting cannot explode
        exposition cardinality.  Values are escaped at render time."""
        with self._lock:
            fam = self._labeled.get(name)
            if fam is None or fam[0] != key:
                fam = (key, {})
                self._labeled[name] = fam
            samples = fam[1]
            if label not in samples and len(samples) >= LABELED_CAP:
                victim = min(samples, key=lambda l: samples[l][1])
                del samples[victim]
            samples[label] = (value, time.monotonic())

    def labeled_gauge(self, name: str) -> Dict[str, float]:
        """Current samples of one labeled-gauge family: {label: value}."""
        with self._lock:
            fam = self._labeled.get(name)
            return {} if fam is None else {
                l: v for l, (v, _t) in fam[1].items()
            }

    def prune_labeled_gauge(self, name: str, keep) -> None:
        """Drop every label of family ``name`` not in ``keep`` — the
        lifecycle half of the bounded-labels contract: a label whose
        subject is GONE (a departed peer past its staleness TTL) must
        leave the exposition, not report its last value forever."""
        keep = set(keep)
        with self._lock:
            fam = self._labeled.get(name)
            if fam is None:
                return
            for label in [l for l in fam[1] if l not in keep]:
                del fam[1][label]

    def set_info(self, name: str, value: object) -> None:
        """Publish one structured configuration fact (JSON-able; e.g. the
        ``config_fences`` list).  Unlike gauges these survive reset()."""
        with self._lock:
            self._info[name] = value

    def info(self, name: str, default: object = None) -> object:
        with self._lock:
            return self._info.get(name, default)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def percentile(self, name: str, p: float) -> float:
        with self._lock:
            return self._hists[name].percentile(p)

    def rate(self, name: str, window_s: float = 60.0) -> float:
        """Average counter rate over (approximately) the last ``window_s``
        seconds, NOT over registry lifetime.

        Samples are taken at read time: each call records (now, value) and
        the rate is computed against the oldest retained sample — retained
        means inside the window, or the one newest sample just outside it
        (the anchor for pollers spaced wider than the window) — so the
        number tracks current traffic instead of diluting
        toward zero as the process ages — and ``reset()`` mid-bench drops
        the sample history with the counters, so a post-reset read can
        never divide a fresh count by a stale anchor (the pre-ISSUE-6 bug
        class).  The first read of a counter falls back to value divided
        by registry lifetime (the only window that exists yet).
        """
        now = time.monotonic()
        with self._lock:
            cur = self._counters.get(name, 0.0)
            hist = self._rate_hist.setdefault(name, deque())
            # Keep the NEWEST sample outside the window as the anchor:
            # popping every out-of-window sample would leave a poller
            # spaced wider than the window with no anchor at all and fall
            # back to the lifetime average every read.
            while len(hist) >= 2 and now - hist[1][0] > window_s:
                hist.popleft()
            if hist:
                t_old, v_old = hist[0]
                dt = now - t_old
                out = (cur - v_old) / dt if dt > 0 else 0.0
            else:
                dt = now - self._t0
                out = cur / dt if dt > 0 else 0.0
            hist.append((now, cur))
            return max(0.0, out)

    # -- per-tenant accounting ----------------------------------

    def _tenant(self, tenant: str) -> _TenantStats:
        """Stats record for ``tenant`` (lock held by the caller)."""
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= TENANT_CAP:
                idle = [
                    t for t, s in self._tenants.items()
                    if s.in_flight == 0 and t != TENANT_OVERFLOW
                ]
                if idle:
                    victim = min(idle, key=lambda t: self._tenants[t].last)
                    del self._tenants[victim]
                else:
                    return self._tenants.setdefault(
                        TENANT_OVERFLOW, _TenantStats()
                    )
            st = self._tenants[tenant] = _TenantStats()
        st.last = time.monotonic()
        return st

    def tenant_begin(self, tenant: str) -> None:
        """One generation request for ``tenant`` entered the engine."""
        if not tenant:
            return
        with self._lock:
            st = self._tenant(tenant)
            st.in_flight += 1
            st.requests += 1

    def tenant_end(self, tenant: str) -> None:
        """The matching exit for tenant_begin (every finish path).

        Balances against whichever record absorbed the begin: the named
        record when it holds flight, else the overflow bucket — a begin
        that lumped into ``~other`` at the cap must not leak a permanent
        in-flight count there when the end arrives after a slot freed up
        (tenant_end never CREATES a record; only begin does).
        """
        if not tenant:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None and st.in_flight > 0:
                st.in_flight -= 1
                st.last = time.monotonic()
                return
            ov = self._tenants.get(TENANT_OVERFLOW)
            if ov is not None and ov.in_flight > 0:
                ov.in_flight -= 1
                ov.last = time.monotonic()

    def tenant_tokens(self, tenant: str, n: int = 1) -> None:
        """Charge ``n`` decode tokens to ``tenant`` (the hot path)."""
        if not tenant:
            return
        with self._lock:
            self._tenant(tenant).tokens += n

    def tenant_shed(self, tenant: str) -> None:
        """One request shed by tenant-fair admission."""
        with self._lock:
            self._counters["engine_tenant_sheds_total"] += 1
            if tenant:
                self._tenant(tenant).sheds += 1

    def _tenant_rate(self, st: _TenantStats, now: float,
                     window_s: float) -> float:
        """Sliding-window token rate (lock held; same anchor-retention
        scheme as rate())."""
        hist = st.samples
        while len(hist) >= 2 and now - hist[1][0] > window_s:
            hist.popleft()
        if hist:
            t_old, v_old = hist[0]
            dt = now - t_old
            out = (st.tokens - v_old) / dt if dt > 0 else 0.0
        else:
            dt = now - self._t0
            out = st.tokens / dt if dt > 0 else 0.0
        hist.append((now, st.tokens))
        return max(0.0, out)

    def tenant_snapshot(self, window_s: float = 30.0) -> Dict[str, Dict[str, float]]:
        """Per-tenant rollup for /healthz and the Prometheus exposition:
        ``{tenant: {in_flight, requests, tokens, tokens_per_s, sheds}}``.
        Reading samples the token-rate window, so spaced pollers see
        current traffic, not lifetime averages."""
        now = time.monotonic()
        with self._lock:
            return {
                t: {
                    "in_flight": float(st.in_flight),
                    "requests": st.requests,
                    "tokens": st.tokens,
                    "tokens_per_s": round(
                        self._tenant_rate(st, now, window_s), 3
                    ),
                    "sheds": st.sheds,
                }
                for t, st in sorted(self._tenants.items())
            }

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            for name, hist in self._hists.items():
                if hist.count:
                    p50, p95, p99, p999 = hist.percentiles(
                        (50, 95, 99, 99.9)
                    )
                    out[f"{name}_p50"] = p50
                    out[f"{name}_p95"] = p95
                    out[f"{name}_p99"] = p99
                    out[f"{name}_p999"] = p999
                    out[f"{name}_count"] = float(hist.count)
            return out

    #: Prometheus summary quantiles every histogram exposes.
    PROM_QUANTILES = (("0.5", 50.0), ("0.95", 95.0), ("0.99", 99.0),
                      ("0.999", 99.9))
    #: Exposition content type (the text format version Prometheus scrapes).
    PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def prometheus_text(self) -> str:
        """The FULL catalog in Prometheus text exposition format.

        Every catalogued name appears (zero-valued when never written), so
        a scraper's first sample already carries the complete schema —
        dashboards never have to guess whether a missing series means
        "zero" or "typo".  Histograms render as summaries with the
        PROM_QUANTILES quantiles.  Kind is derived from the catalogue
        entry itself: ``*_total`` = counter, ``(histogram`` in the
        description = summary, everything else = gauge — the same
        convention the descriptions already follow.  The ``tenant_*``
        names render as LABELED series ({tenant="..."}) from the
        per-tenant table — one sample per tracked tenant, none when no
        tenanted traffic has arrived.
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {
                name: (
                    list(zip(
                        (q for q, _p in self.PROM_QUANTILES),
                        h.percentiles([p for _q, p in self.PROM_QUANTILES]),
                    )),
                    h.count,
                )
                for name, h in self._hists.items()
            }
            labeled = {
                name: (key, {l: v for l, (v, _t) in samples.items()})
                for name, (key, samples) in self._labeled.items()
            }
        tenants = self.tenant_snapshot()
        tenant_field = {
            "tenant_in_flight": "in_flight",
            "tenant_requests_total": "requests",
            "tenant_tokens_total": "tokens",
            "tenant_tokens_per_s": "tokens_per_s",
            "tenant_sheds_total": "sheds",
        }
        lines: List[str] = []
        for name, desc in METRICS_CATALOG.items():
            help_text = " ".join(desc.split())
            lines.append(f"# HELP {name} {help_text}")
            if name in tenant_field:
                kind = "counter" if name.endswith("_total") else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                for t, row in tenants.items():
                    lines.append(prom_sample(
                        name, {"tenant": t}, row[tenant_field[name]]
                    ))
                continue
            if "labeled {" in desc:
                # Generic labeled-gauge families (fleet_*/slo_*): one
                # sample per tracked label from the bounded store, none
                # before the first write (the tenant_* convention).
                lines.append(f"# TYPE {name} gauge")
                key, samples = labeled.get(name, ("", {}))
                for l in sorted(samples):
                    lines.append(prom_sample(name, {key: l}, samples[l]))
                continue
            if "(histogram" in desc:
                lines.append(f"# TYPE {name} summary")
                quantiles, count = hists.get(name, ([], 0))
                for q, v in quantiles:
                    lines.append(f'{name}{{quantile="{q}"}} {v:.6g}')
                lines.append(f"{name}_count {count}")
            elif name.endswith("_total"):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {counters.get(name, 0.0):.6g}")
            else:
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {gauges.get(name, 0.0):.6g}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._rate_hist.clear()
            self._tenants.clear()
            self._labeled.clear()
            self._t0 = time.monotonic()


#: Process-wide default registry.
global_metrics = Metrics()


# ---------------------------------------------------------------------------
# federated exposition: the proxy's /metrics?fleet=1 merger
# ---------------------------------------------------------------------------

#: Metric-family prefixes that belong to a SERVE peer's process: the
#: federation merger relabels these with ``peer="..."`` from each scraped
#: exposition, and drops them from the proxy's local section (the proxy's
#: own zero-valued copies of engine_*/serve_* series would otherwise sit
#: unlabeled next to the real labeled ones — the TC06 silent-zero class,
#: fleet edition).
PEER_SCOPED_PREFIXES = ("engine_", "serve_", "tenant_", "transport_",
                        "slo_")

#: The subset the PROXY process actually writes: its lane in the fleet
#: exposition carries only these (the proxy-side ARQ path) — relabeling
#: its full-catalog zero-valued engine_*/serve_* copies would plant a
#: phantom always-zero "proxy" engine peer in every by-peer dashboard
#: aggregation.
PROXY_LANE_PREFIXES = ("transport_",)

#: A sample line: ``name{labels} value`` or ``name value`` (timestamps are
#: never emitted by this registry and are not merged).  The label group is
#: quote-aware: a ``}`` INSIDE a quoted label value (tenant ids are
#: client-controlled strings) must not end the group early, or that
#: series would be silently dropped from the fleet exposition.
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)"
    r"(\{(?:[^\"}]|\"(?:[^\"\\]|\\.)*\")*\})?"
    r"\s+(\S+)\s*$"
)


def sum_counter_samples(texts: "Dict[str, Optional[str]]", name: str) -> float:
    """Sum one UNLABELED counter/gauge family across scraped expositions
    (stale peers — None — contribute nothing).  The fleet aggregate
    helper: e.g. serve_shed_total summed over every fresh peer."""
    total = 0.0
    for text in texts.values():
        if not text:
            continue
        for line in text.splitlines():
            m = _SAMPLE_RE.match(line)
            if m and m.group(1) == name and not m.group(2):
                try:
                    total += float(m.group(3))
                except ValueError:
                    pass
    return total


def federate_prometheus_texts(
    peer_texts: "Dict[str, Optional[str]]", local_text: str
) -> str:
    """Merge per-peer /metrics expositions into ONE fleet exposition.

    Every sample of a peer-scoped family (PEER_SCOPED_PREFIXES) gains a
    leading ``peer="<id>"`` label — existing labels (``{tenant=...}``,
    ``{quantile=...}``, ``{objective=...}``) are preserved after it, so
    per-tenant and summary series stay distinguishable per peer.  The
    PROXY process is a lane too, restricted to the families it actually
    writes (PROXY_LANE_PREFIXES — the live ``transport_*`` series of the
    proxy-side ARQ path): those ride relabeled as ``peer="proxy"`` —
    dropping them would blind a fleet dashboard to proxy-side retransmit
    storms, while relabeling the proxy's full-catalog zero-valued
    engine_*/serve_* copies would plant a phantom always-zero engine peer
    in every by-peer aggregation.  HELP/TYPE metadata is
    emitted once per family.  A peer whose scrape failed (value None)
    contributes no samples — its absence is marked by the
    ``fleet_peer_scrape_stale{peer=...}`` series the caller publishes into
    the LOCAL registry before rendering ``local_text``.  The local
    exposition additionally contributes the non-peer-scoped families
    (proxy_*, fleet_*), unlabeled.

    Label syntax interpolation is confined to this module (tunnelcheck
    TC12); values pass through :func:`prom_label_escape`.
    """
    lines: List[str] = []
    seen_meta: set = set()
    sources = [
        (pid, peer_texts[pid], PEER_SCOPED_PREFIXES)
        for pid in sorted(peer_texts)
    ]
    sources.append(("proxy", local_text, PROXY_LANE_PREFIXES))
    for pid, text, prefixes in sources:
        if text is None:
            continue
        peer_prefix = f'peer="{prom_label_escape(pid)}"'
        for line in text.splitlines():
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                    continue
                fam = parts[2]
                if not fam.startswith(prefixes):
                    continue
                meta_key = (parts[1], fam)
                if meta_key in seen_meta:
                    continue
                seen_meta.add(meta_key)
                lines.append(line)
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, labels, value = m.groups()
            if not name.startswith(prefixes):
                continue
            existing = labels[1:-1] if labels else ""
            inner = f"{peer_prefix},{existing}" if existing else peer_prefix
            lines.append(f"{name}{{{inner}}} {value}")
    for line in local_text.splitlines():
        if line.startswith("#"):
            parts = line.split(None, 3)
            if (len(parts) >= 3 and parts[1] in ("HELP", "TYPE")
                    and parts[2].startswith(PEER_SCOPED_PREFIXES)):
                continue
            lines.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is not None and m.group(1).startswith(PEER_SCOPED_PREFIXES):
            continue
        lines.append(line)
    return "\n".join(lines) + "\n"


def derived_retry_after_s(backlog: int, rate_name: str, gauge: str) -> float:
    """THE queue-derived Retry-After advisory, shared by the
    engine (queue depth over admission drain) and the serve loop
    (in-flight over dispatch rate) so the formula cannot drift between
    layers: time to turn over ``backlog``+1 units at ``rate_name``'s
    recent (10 s window) rate, clamped to [1, 60] s.  A stalled server
    (zero rate, nonzero backlog) reports the cap rather than pretending
    1 s will help; an idle one reports the floor.  Publishes ``gauge``
    on every computation so the advisory is scrapeable next to the 429
    counters."""
    rate = global_metrics.rate(rate_name, window_s=10.0)
    if rate > 0:
        out = (backlog + 1) / rate
    else:
        out = 1.0 if backlog == 0 else 60.0
    out = min(60.0, max(1.0, out))
    global_metrics.set_gauge(gauge, out)
    return out
