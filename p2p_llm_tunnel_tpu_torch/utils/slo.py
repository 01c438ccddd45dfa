"""Declarative SLOs evaluated as multi-window error-budget burn rates.

The metrics registry reports WHAT happened (tok/s, TTFT percentiles); this
module answers the operator question those numbers only imply: *is the
service meeting its objectives, and if not, how fast is it failing?*  Each
:class:`Objective` reduces to a good/bad event stream against a required
good fraction (the SRE formulation): a latency objective "TTFT p99 ≤ 2 s"
is "≥ 99% of requests must see TTFT ≤ 2 s", an availability objective
"99.9% of requests answered" is the stream of served-vs-shed outcomes.

Verdicts come from **multi-window burn rates** (Google SRE Workbook ch. 5):
the error rate over a window divided by the error budget (1 − target).
Burn 1.0 consumes exactly the sustainable budget; the alert threshold
(default 14.4, the SRE fast-page factor) flags consumption that would
exhaust a month's budget in hours.

- ``ok``       — neither window burns at ≥ the threshold (or too few
                 events to judge: ``min_events``)
- ``burning``  — the FAST (~5 min) window burns at ≥ threshold: budget is
                 being consumed unsustainably right now.  Wired into the
                 serve /healthz ``degraded`` signal, so fabric routing
                 steers load away before the objective is lost.
- ``breached`` — the SLOW (~1 h) window burns at ≥ threshold too: the
                 violation is sustained, not a blip.

Design constraints, in priority order:

- **Pure and clock-injectable.**  No I/O, no jax, no wall-clock reads
  outside the injected ``clock`` — evaluation over a fixed event sequence
  is a deterministic function, so two seeded chaos runs produce identical
  verdicts and the unit tests drive a fake clock through window expiry.
- **Counts, not wall-clock rates.**  Error rate is bad/(good+bad) within
  the window — a ratio of deterministic counts — never events-per-second,
  which would make verdicts timing-dependent.
- **Bounded.**  Events land in coarse buckets (``bucket_s``); memory per
  objective is O(slow_window / bucket_s) regardless of traffic.
- **Off by default.**  Like tracing, the process-global engine is inert
  (``record`` returns immediately) until ``configure(enabled=True)`` —
  the serve CLI's ``--slo`` (default on); bare library use costs nothing
  and cannot flip test /healthz statuses.

Verdicts publish as ``slo_*`` labeled gauges through the bounded registry
helpers (tunnelcheck TC12) and as the /healthz ``slo`` section.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from p2p_llm_tunnel_tpu_torch.utils.metrics import Metrics, global_metrics

#: Fast / slow evaluation windows (seconds): ~5 min catches "failing right
#: now", ~1 h distinguishes a sustained violation from a blip.
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
#: Burn-rate alert threshold: the SRE Workbook's fast-page factor (a 30-day
#: budget consumed in ~2 days).  Budget consumption below this reads as ok.
BURN_THRESHOLD = 14.4
#: Event-bucket granularity; bounds memory at slow_window/bucket_s buckets.
BUCKET_S = 10.0
#: Verdicts need evidence: below this many events in the slow window an
#: objective reports ok — one unlucky request out of three must not page.
MIN_EVENTS = 10

_STATE_CODE = {"ok": 0.0, "burning": 1.0, "breached": 2.0}


@dataclass(frozen=True)
class Objective:
    """One declarative objective over a good/bad event stream.

    ``target`` is the required good fraction (0, 1).  ``threshold_ms``
    marks a latency objective: :meth:`SloEngine.record_latency` maps a
    sample to good = (sample ≤ threshold_ms); availability objectives are
    fed good/bad directly via :meth:`SloEngine.record`.
    """

    name: str
    target: float
    threshold_ms: Optional[float] = None
    description: str = ""

    @property
    def budget(self) -> float:
        """Error budget: the tolerated bad fraction (floored > 0 so a
        target of 1.0 cannot divide by zero — it burns infinitely fast
        instead, which is what a zero-budget objective means)."""
        return max(1e-9, 1.0 - self.target)


def default_objectives(
    ttft_ms: Optional[float] = None,
    ttft_target: Optional[float] = None,
    availability_target: Optional[float] = None,
) -> List[Objective]:
    """The serving stack's stock objectives (env-overridable defaults):
    TTFT p99 ≤ ``ttft_ms`` and availability ≥ ``availability_target``."""
    if ttft_ms is None:
        ttft_ms = float(os.environ.get("TUNNEL_SLO_TTFT_MS", "2000"))
    if ttft_target is None:
        ttft_target = float(os.environ.get("TUNNEL_SLO_TTFT_TARGET", "0.99"))
    if availability_target is None:
        availability_target = float(
            os.environ.get("TUNNEL_SLO_AVAIL_TARGET", "0.999")
        )
    return [
        Objective(
            "ttft", ttft_target, threshold_ms=ttft_ms,
            description=f"TTFT p{ttft_target * 100:g} <= {ttft_ms:g} ms",
        ),
        Objective(
            "availability", availability_target,
            description=(
                f"requests answered without shed/error >= "
                f"{availability_target * 100:g}%"
            ),
        ),
    ]


class SloEngine:
    """Bounded, thread-safe burn-rate evaluator over declarative objectives.

    All methods are cheap enough for the serving path: ``record`` is one
    lock + deque append; nothing here dispatches, allocates per event, or
    reads the wall clock except through the injected ``clock``.
    """

    def __init__(
        self,
        objectives: Sequence[Objective] = (),
        *,
        clock: Callable[[], float] = time.monotonic,
        fast_window_s: float = FAST_WINDOW_S,
        slow_window_s: float = SLOW_WINDOW_S,
        burn_threshold: float = BURN_THRESHOLD,
        bucket_s: float = BUCKET_S,
        min_events: int = MIN_EVENTS,
        enabled: bool = False,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.bucket_s = max(1e-6, bucket_s)
        self.min_events = min_events
        self.enabled = enabled
        self.objectives: Dict[str, Objective] = {}
        #: Last PUBLISHED state per objective — the transition memory
        #: behind the on_alert hook (worsening edges only fire once).
        self._published_states: Dict[str, str] = {}
        #: name -> deque of [bucket_start_s, good, bad], oldest first.
        self._buckets: Dict[str, Deque[List[float]]] = {}
        for obj in objectives:
            self.objectives[obj.name] = obj
            self._buckets[obj.name] = deque()

    def configure(
        self,
        *,
        enabled: Optional[bool] = None,
        objectives: Optional[Sequence[Objective]] = None,
        burn_threshold: Optional[float] = None,
        min_events: Optional[int] = None,
    ) -> None:
        """Reconfigure in place (the CLI entry point).  Replacing the
        objective set drops accumulated events — a changed target redefines
        what good meant, so old buckets would mislead."""
        with self._lock:
            if objectives is not None:
                self.objectives = {o.name: o for o in objectives}
                self._buckets = {o.name: deque() for o in objectives}
                # A replaced objective set redefines the verdicts, so the
                # on_alert transition memory starts over with the buckets
                # — stale "already breached" states from a previous
                # configuration must not swallow the fresh set's first
                # worsening edge.
                self._published_states.clear()
            if burn_threshold is not None:
                self.burn_threshold = burn_threshold
            if min_events is not None:
                self.min_events = min_events
            if enabled is not None:
                self.enabled = bool(enabled)

    def reset(self) -> None:
        """Drop accumulated events (objectives and config stay)."""
        with self._lock:
            for dq in self._buckets.values():
                dq.clear()
            self._published_states.clear()

    # -- feeding ----------------------------------------------------------

    def record(self, name: str, good: bool) -> None:
        """One event for objective ``name``.  Unknown objectives are
        ignored (a feed site must never crash serving because an operator
        removed an objective); disabled engines return immediately."""
        if not self.enabled:
            return
        with self._lock:
            dq = self._buckets.get(name)
            if dq is None:
                return
            now = self._clock()
            start = now - (now % self.bucket_s)
            if not dq or dq[-1][0] != start:
                dq.append([start, 0.0, 0.0])
                self._prune(dq, now)
            dq[-1][1 if good else 2] += 1.0

    def record_latency(self, name: str, value_ms: float) -> None:
        """One latency sample for a threshold objective: good iff the
        sample is within the objective's ``threshold_ms``."""
        if not self.enabled:
            return
        obj = self.objectives.get(name)
        if obj is None or obj.threshold_ms is None:
            return
        self.record(name, value_ms <= obj.threshold_ms)

    def _prune(self, dq: Deque[List[float]], now: float) -> None:
        horizon = now - self.slow_window_s - self.bucket_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    # -- evaluation -------------------------------------------------------

    def _window_counts(self, dq, now: float, window_s: float):
        cutoff = now - window_s
        good = bad = 0.0
        for start, g, b in dq:
            if start + self.bucket_s > cutoff:
                good += g
                bad += b
        return good, bad

    def evaluate(self) -> Dict[str, Dict[str, object]]:
        """Per-objective verdicts: ``{name: {state, burn_fast, burn_slow,
        target, events_fast, events_slow}}``.  Pure function of the fed
        events and the injected clock — identical across two runs that fed
        the same sequence (the seeded-chaos determinism contract)."""
        with self._lock:
            now = self._clock()
            out: Dict[str, Dict[str, object]] = {}
            for name, obj in self.objectives.items():
                dq = self._buckets.get(name, ())
                gf, bf = self._window_counts(dq, now, self.fast_window_s)
                gs, bs = self._window_counts(dq, now, self.slow_window_s)
                nf, ns = gf + bf, gs + bs
                err_f = bf / nf if nf else 0.0
                err_s = bs / ns if ns else 0.0
                burn_f = err_f / obj.budget
                burn_s = err_s / obj.budget
                # The fast window needs its own evidence (nf gate): with
                # 10+ slow-window events but a near-empty fast window, one
                # transient 502 would otherwise read as burning and
                # de-route a healthy peer for up to fast_window_s.  And
                # BOTH windows must burn for breached — the SRE multi-
                # window conjunction: the slow window alone staying hot
                # after errors STOPPED would otherwise keep a recovered
                # peer degraded/de-routed for up to slow_window_s.
                if ns < self.min_events or nf < self.min_events:
                    state = "ok"
                elif (burn_s >= self.burn_threshold
                        and burn_f >= self.burn_threshold):
                    state = "breached"
                elif burn_f >= self.burn_threshold:
                    state = "burning"
                else:
                    state = "ok"
                out[name] = {
                    "state": state,
                    "burn_fast": round(burn_f, 3),
                    "burn_slow": round(burn_s, 3),
                    "target": obj.target,
                    "events_fast": int(nf),
                    "events_slow": int(ns),
                }
                if obj.threshold_ms is not None:
                    out[name]["threshold_ms"] = obj.threshold_ms
            return out

    #: Optional worsening-transition hook: called as
    #: ``on_alert(objective, new_state, verdicts)`` when an objective's
    #: published state WORSENS (ok -> burning/breached, burning ->
    #: breached).  utils/flight.py wires the postmortem black box here, so
    #: an SLO incident snapshots the engine at the moment the budget burn
    #: crossed the alert threshold — not minutes later when an operator
    #: looks.  Exceptions are swallowed: an alert hook must never take
    #: down the serving path it observes.
    on_alert: Optional[Callable[[str, str, dict], None]] = None

    def publish(self, metrics: Optional[Metrics] = None) -> Dict[str, Dict[str, object]]:
        """Evaluate and publish the ``slo_*`` catalog series through the
        bounded labeled-gauge helpers; returns the evaluation.  No-op
        (empty dict) while disabled, so a disabled engine never plants
        labeled series in a test's exposition."""
        if not self.enabled:
            return {}
        metrics = metrics if metrics is not None else global_metrics
        verdicts = self.evaluate()
        worsened: List[Tuple[str, str]] = []
        for name, v in verdicts.items():
            metrics.set_labeled_gauge(
                "slo_burn_fast", "objective", name, float(v["burn_fast"])
            )
            metrics.set_labeled_gauge(
                "slo_burn_slow", "objective", name, float(v["burn_slow"])
            )
            state = str(v["state"])
            metrics.set_labeled_gauge(
                "slo_state", "objective", name, _STATE_CODE[state]
            )
            prev = self._published_states.get(name, "ok")
            if _STATE_CODE[state] > _STATE_CODE.get(prev, 0.0):
                worsened.append((name, state))
            self._published_states[name] = state
        hook = self.on_alert
        if hook is not None:
            for name, state in worsened:
                try:
                    hook(name, state, verdicts)
                except Exception:
                    pass  # observability must not break serving
        return verdicts

    def section(self) -> Dict[str, object]:
        """The /healthz ``slo`` section: enabled flag, per-objective
        verdicts, and ``alerting`` — True when any objective is burning or
        breached (the hook /healthz folds into its degraded status, which
        the fabric's health routing then steers around)."""
        verdicts = self.publish()
        return {
            "enabled": self.enabled,
            "alerting": any(
                v["state"] != "ok" for v in verdicts.values()
            ),
            "objectives": verdicts,
        }


#: Process-wide default engine (disabled until configure(enabled=True) —
#: the serve CLI's --slo flag, or TUNNEL_SLO=1 for spawned stacks).
global_slo = SloEngine(
    default_objectives(),
    enabled=os.environ.get("TUNNEL_SLO", "") == "1",
)
