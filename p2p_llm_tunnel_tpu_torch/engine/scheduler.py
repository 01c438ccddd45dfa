"""Continuous-batching slot scheduler (pure logic, no JAX, no IO).

SURVEY.md §7 hard-part #1: map an unbounded set of concurrent streams onto a
fixed number of static-shape decode slots.  The scheduler owns admission
(FIFO with slot+capacity checks) and eviction (EOS / token budget / cache
full); the engine drives it and runs the XLA programs.  Pure and synchronous
so it is unit-testable against fake streams (tests/test_scheduler.py).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """Parse a ``name=weight,name=weight`` fairness spec (EngineConfig.
    tenant_weights / --tenant-weights).  Unlisted tenants weigh 1.0.
    Raises ValueError on malformed entries or non-positive weights — a
    fairness policy that silently half-parses is worse than none.
    """
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(f"tenant weight must be name=weight, got {part!r}")
        try:
            w = float(val)
        except ValueError:
            raise ValueError(f"bad weight for tenant {name!r}: {val!r}")
        if w <= 0:
            raise ValueError(f"tenant {name!r} weight must be > 0, got {w}")
        out[name.strip()] = w
    return out


class MuxController:
    """Adaptive iteration-level prefill token budget (pure logic).

    The multiplexed engine loop (DistServe's prefill/decode
    interference argument) dispatches ONE decode burst per iteration plus
    up to ``budget_tokens`` of prefill work — chunked-prefill segment rows,
    or whole-prompt rows on configs where the chunk path is illegal.  This
    controller picks that budget each iteration from three signals:

    - **queue depth + prefill backlog** (admission pressure): more queued
      work widens the budget toward the cap;
    - **per-request deadline slack**: a queued/backlogged request within
      ``SLACK_RESCUE_S`` of its deadline gets the full cap — shedding a
      request at its deadline because the controller was polite to decode
      is the worst goodput outcome;
    - **a decode-stall bound**: while decode streams are live, prefill is
      capped at a fraction of the row width (quarter normally, half under
      pressure), so one iteration's prefill work can never stall running
      streams for more than a bounded slice of the loop cadence.

    Pure and deterministic on purpose (same charter as :class:`Scheduler`):
    the engine feeds it host-side observations; unit tests drive it with
    fake ones (tests/test_mux.py).
    """

    #: Queued work within this many seconds of its deadline lifts the
    #: budget to the cap regardless of decode pressure.
    SLACK_RESCUE_S = 1.0

    def __init__(self, unit_tokens: int, max_rows: int,
                 fixed_tokens: int = 0):
        if unit_tokens < 1 or max_rows < 1:
            raise ValueError("unit_tokens and max_rows must be >= 1")
        self.unit = unit_tokens
        self.max_rows = max_rows
        #: Operator override (EngineConfig.mux_budget_tokens): a fixed
        #: budget disables adaptation entirely — the A/B lever.
        self.fixed = fixed_tokens

    @property
    def cap_tokens(self) -> int:
        return self.unit * self.max_rows

    def budget_tokens(
        self,
        *,
        queue_depth: int,
        backlog_rows: int,
        active_rows: int,
        min_slack_s: Optional[float] = None,
        decode_row_tokens: int = 1,
    ) -> int:
        """Prefill token budget for ONE loop iteration.

        ``backlog_rows`` counts remaining prefill DISPATCH rows (segments
        still to run + pending whole-prompt rows — the engine sums
        per-request remaining segment counts); ``active_rows`` counts live
        decode streams; ``min_slack_s`` is the tightest deadline slack
        across queued + backlogged requests (None = no deadlines).  The
        returned budget may exceed one dispatch's width — the engine
        pipelines it as back-to-back ``prefill_rows``-wide sub-batches.

        ``decode_row_tokens`` is the TRUE token cost one decode iteration
        pays per active row: a speculative verify burst emits
        up to K+1 tokens per slot in one weight-stream pass, so the engine
        passes ``1 + K`` when spec will run.  The decode-stall bound
        scales its prefill allowance DOWN by that factor — each iteration
        already moves K+1× the tokens per stall-second, so holding the
        prefill slice constant would silently grow prefill's share of
        iteration wall from a quarter toward everything as K grows."""
        demand = queue_depth + backlog_rows
        if demand <= 0:
            return 0
        drain = max(1, backlog_rows) * self.unit
        if self.fixed > 0:
            # Clamped to at least one dispatch row: a fixed budget below
            # the segment width would otherwise floor to zero rows at the
            # engine and stall every admission forever.
            return min(max(self.fixed, self.unit), drain)
        if active_rows == 0:
            # Nothing to stall: drain the whole backlog this iteration
            # (the engine pipelines it as back-to-back sub-batches).
            return drain
        if min_slack_s is not None and min_slack_s < self.SLACK_RESCUE_S:
            return drain
        if demand >= active_rows:
            # More work waiting than streams running: admission pressure
            # dominates goodput (DistServe) — throttling prefill here
            # idles decode slots to protect the few streams already
            # holding them, and the iteration overhead of a dribbled
            # drain costs MORE decode throughput than the stall it avoids
            # (measured on the 32-client CPU herd: the throttled drain
            # doubled TTFT p50 at a 10% tok/s loss).
            return drain
        # Decode-stall bound: with a mostly-busy batch and a shallow
        # queue, live streams keep at least half (under pressure) /
        # three quarters (normally) of each iteration's work — measured
        # in TOKENS, so a verify burst's K+1-per-row cost shrinks the
        # prefill slice proportionally.
        if demand >= self.max_rows:
            rows = max(1, self.max_rows // 2)
        else:
            rows = max(1, self.max_rows // 4)
        rows = max(1, rows // max(1, decode_row_tokens))
        return min(rows * self.unit, drain)


class QueueFull(Exception):
    """The bounded waiting queue is at capacity; shed instead of buffering.

    Carries no retry hint — admission latency depends on in-flight work the
    scheduler cannot see; callers map this to HTTP 429 + ``Retry-After``.
    """

    #: Typed tunnel-error code (protocol.frames.TunnelMessage.typed_error).
    tunnel_code = "busy"


class TenantOverLimit(QueueFull):
    """One tenant exceeded its weighted-fair share of a CONTENDED ingress.

    Raised instead of plain :class:`QueueFull` when the waiting queue has
    room in aggregate but the submitting tenant is already holding its fair
    share of it while other tenants are active — the hot tenant is shed
    BEFORE it can displace anyone else.  Also raised by a
    displaced request's consumer: when a full queue is monopolized by an
    over-share tenant, an under-share tenant's submit evicts the
    monopolist's newest queued request rather than bouncing the victim.
    """

    #: Typed tunnel-error code (protocol.frames.TunnelMessage.typed_error).
    tunnel_code = "tenant_overlimit"


@dataclass
class GenRequest:
    """One generation request as admitted to the batch."""

    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    freq_pen: float = 0.0  # OpenAI frequency_penalty over generated tokens
    pres_pen: float = 0.0  # OpenAI presence_penalty over generated tokens
    logprobs: int = 0  # top_logprobs to report per token (0 = off)
    # Echo/scoring: compute per-prompt-token logprobs during prefill
    # (forces the whole-prompt plain prefill path).
    echo_logprobs: bool = False
    stop_ids: tuple = ()
    # Per-request sampling seed (uint32): randomness is a pure function of
    # (seed, token position) — batch-composition independent, reproducible.
    # The engine auto-derives one from the request id when not given.
    seed: int = 0
    # OpenAI logit_bias as ((token_id, bias), ...); applied to the raw
    # logits on-device for every sampled token of this request.
    logit_bias: tuple = ()
    # Absolute monotonic-clock deadline (seconds); expire() evicts the
    # request — queued OR running — once now passes it, so a slow client
    # can never pin a decode slot forever.  None = no deadline.
    deadline: Optional[float] = None
    # Tenant identity: the x-tunnel-tenant value stamped at the
    # proxy (API key, falling back to room/connection).  "" = untenanted —
    # all such requests share one anonymous bucket, which degenerates to
    # the pre-tenant FIFO behavior when nothing else is tagged.
    tenant: str = ""

    def __post_init__(self) -> None:
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclass
class RunningSlot:
    request: GenRequest
    slot: int
    cache_len: int  # prompt tokens written so far + generated tokens
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        return bool(self.generated) and self.generated[-1] in self.request.stop_ids


class Scheduler:
    """Fixed-slot admission/eviction; weighted-fair among tenants, FIFO
    within each tenant.

    ``max_waiting`` bounds the waiting queue (0 = unbounded): under overload
    submit() raises QueueFull instead of buffering work the engine cannot
    finish — the goodput-over-throughput shedding DistServe/AlignedServe
    argue for (PAPERS.md).

    Tenant fairness (``fair=True``): admission order is stride
    scheduling over tenants — each tenant carries a monotone *pass* value
    advanced by ``1/weight`` per admission (plus ``TOKEN_COST/weight`` per
    decode token the engine charges back via :meth:`charge_tokens`), and
    admit() always picks the backlogged tenant with the smallest pass.
    While other tenants are ACTIVE (queued or running), a tenant is
    additionally held to its weight share on both axes: its *running
    slots* are capped at its fraction of ``num_slots`` (:meth:`slot_cap` —
    the latency reservation that keeps an aggressor's admitted streams
    from saturating the decode batch) and its share of the *waiting
    queue* is capped at its fraction of ``max_waiting`` — an over-share
    submitter gets :class:`TenantOverLimit`, and when the queue is
    already full of an over-share tenant's backlog, an under-share
    submitter DISPLACES the monopolist's newest queued request (submit()
    returns the displaced requests so the engine can shed their consumers
    with the same typed error).  A lone active tenant sees plain FIFO and
    may use every slot and the whole queue; fairness costs nothing until
    a second tenant shows up, and a tenant with no work reserves nothing.
    Pure and deterministic: same submission sequence, same outcome.
    """

    #: Pass advanced per decode token charged back by the engine, relative
    #: to the 1.0 charged per admission: 64 streamed tokens weigh like one
    #: extra admission, so a tenant holding long ignore_eos streams loses
    #: queue priority to one issuing short requests even at equal request
    #: rates.
    TOKEN_COST = 1.0 / 64.0

    def __init__(self, num_slots: int, max_seq: int, max_waiting: int = 0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 fair: bool = True):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.max_waiting = max_waiting
        self.fair = fair
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        self.waiting: Deque[GenRequest] = deque()
        self.slots: List[Optional[RunningSlot]] = [None] * num_slots
        #: Stride-scheduling state: per-tenant pass value + the global
        #: virtual time (the pass of the last tenant served), which anchors
        #: joining tenants so idle time never banks priority.
        self._pass: Dict[str, float] = {}
        self._vt = 0.0
        #: Per-tenant waiting-queue depth, maintained incrementally at every
        #: queue mutation: admission runs several depth/active-tenant
        #: queries per arriving request, and at max_waiting=600 x 1k
        #: clients/s a deque scan per query is the ingress hot path.
        self._depths: Dict[str, int] = {}
        #: Distinct tenants currently holding slots, rebuilt lazily
        #: (``_slots_dirty``) inside charge_tokens: the solo-tenant check
        #: there runs once per generated token per running slot, and an
        #: O(num_slots) scan per call put O(slots^2) Python work into
        #: every decode step.  Scheduler methods that mutate ``slots``
        #: invalidate it; code that writes ``self.slots[i]`` directly
        #: (test shorthand) must not charge tokens before the next
        #: scheduler-driven slot mutation.
        self._running_tenants: frozenset = frozenset()
        self._slots_dirty = False
        #: Page-reservation hook: when set (by the engine, with
        #: a prefix pool configured), admit() calls it once per admitted
        #: request BEFORE the engine sees the admission — the engine
        #: reserves the pool pages the request's prompt insert will want,
        #: evicting cost-aware under pressure AT admission time instead of
        #: thrashing the pool mid-wave.  Pure host work; None = no pool.
        self.page_reserve: Optional[object] = None

    # -- tenant bookkeeping ------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, 1.0)

    def _q_append(self, req: GenRequest) -> None:
        self.waiting.append(req)
        self._depths[req.tenant] = self._depths.get(req.tenant, 0) + 1

    def _q_forget(self, req: GenRequest) -> None:
        """Account one request leaving ``waiting`` (already removed)."""
        d = self._depths.get(req.tenant, 0) - 1
        if d > 0:
            self._depths[req.tenant] = d
        else:
            self._depths.pop(req.tenant, None)

    def _active_tenants(self, extra: Optional[str] = None) -> List[str]:
        """Tenants with queued or running work (deduplicated; deterministic
        order — queued tenants in first-queued order, then running)."""
        seen: List[str] = list(self._depths)
        for run in self.slots:
            if run is not None and run.request.tenant not in seen:
                seen.append(run.request.tenant)
        if extra is not None and extra not in seen:
            seen.append(extra)
        return seen

    def tenant_queue_depth(self, tenant: str) -> int:
        return self._depths.get(tenant, 0)

    def _share(self, bound: int, tenant: str, total_w: float) -> int:
        """THE weighted-share formula: ``tenant``'s weight fraction of
        ``bound`` slots/queue entries over ``total_w``, floored at 1.
        Single source for fair_cap, _overshoots and slot_cap — the
        pre-flight 429 verdict (admission_check → fair_cap/displaceable)
        and the submit outcome agree only while these stay byte-for-byte
        the same arithmetic."""
        return max(1, int(bound * self.weight(tenant) / total_w))

    def fair_cap(self, tenant: str) -> Optional[int]:
        """Max waiting-queue entries ``tenant`` may hold right now, or None
        when no cap applies (unbounded queue, fairness off, or the tenant
        is alone — a lone tenant keeps the whole queue, work-conserving).
        The cap is the tenant's weight fraction of ``max_waiting`` over the
        currently-active tenants, floored at 1 so a configured tenant can
        always queue *something*.
        """
        if self.max_waiting <= 0 or not self.fair:
            return None
        active = self._active_tenants(extra=tenant)
        if len(active) <= 1:
            return None
        total_w = sum(self.weight(t) for t in active)
        return self._share(self.max_waiting, tenant, total_w)

    def charge_tokens(self, tenant: str, n: int) -> None:
        """Charge ``n`` decode tokens against ``tenant``'s stride pass —
        the token-rate half of fair admission: sustained decode consumption
        costs future queue priority exactly like extra admissions would."""
        if not self.fair or n <= 0:
            return
        self._pass[tenant] = (
            self._pass.get(tenant, self._vt)
            + n * self.TOKEN_COST / self.weight(tenant)
        )
        # A LONE tenant's consumption defines the virtual time.  admit()
        # takes the single-tenant FIFO path (never advancing _vt), so
        # without this a solo tenant's pass outruns _vt without bound and
        # — because joiners anchor AT _vt — a second tenant arriving after
        # an hour of solo decode would win every admission tie for
        # arbitrarily long.  Fairness must cost nothing until a second
        # tenant actually shows up, and no debt may outlive the solo era.
        if self._slots_dirty:
            self._running_tenants = frozenset(
                run.request.tenant for run in self.slots if run is not None
            )
            self._slots_dirty = False
        if (all(t == tenant for t in self._depths)
                and self._running_tenants <= {tenant}):
            self._vt = max(self._vt, self._pass[tenant])
        if len(self._pass) > 1024:
            # Cardinality bound: forget the most-caught-up tenants that
            # have no current work (their pass would re-anchor to the
            # virtual time on return anyway).
            active = set(self._active_tenants())
            for t in sorted(self._pass, key=self._pass.get):
                if len(self._pass) <= 512:
                    break
                if t not in active:
                    del self._pass[t]

    def _anchor_if_idle(self, tenant: str) -> None:
        """Stride join rule, applied at the idle→active edge ONLY: a
        tenant with no queued or running work anchors its pass at the
        current virtual time, so idle time banks no priority.  A tenant
        that stayed backlogged keeps its pass untouched — re-anchoring
        every admit() round would forgive a hot tenant's token-charge
        debt (and wipe a slot-capped victim's earned priority) the
        moment the virtual time overtook it."""
        if not self.fair:
            return
        if self._depths.get(tenant):
            return
        for run in self.slots:
            if run is not None and run.request.tenant == tenant:
                return
        self._pass[tenant] = max(self._pass.get(tenant, self._vt), self._vt)

    # -- admission --------------------------------------------------------

    def submit(self, req: GenRequest) -> List[GenRequest]:
        """Queue one request; returns requests DISPLACED to make room.

        Raises QueueFull when the bounded queue is full of in-share work,
        TenantOverLimit when the submitting tenant is over its own share of
        a contended queue.  The returned (usually empty) list holds queued
        requests evicted in the submitter's favor — an under-share tenant
        claiming queue space back from a monopolist; the engine sheds their
        consumers with the same ``tenant_overlimit`` semantics.
        """
        if len(req.prompt_ids) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens does not fit max_seq={self.max_seq}"
            )
        self._anchor_if_idle(req.tenant)
        if self.max_waiting <= 0:
            self._q_append(req)
            return []
        cap = self.fair_cap(req.tenant)
        if cap is not None and self.tenant_queue_depth(req.tenant) >= cap:
            raise TenantOverLimit(
                f"tenant {req.tenant!r} holds its fair share of the "
                f"waiting queue ({cap}/{self.max_waiting})"
            )
        if len(self.waiting) >= self.max_waiting:
            displaced = self._displace(req.tenant)
            if not displaced:
                raise QueueFull(
                    f"waiting queue full ({len(self.waiting)}/{self.max_waiting})"
                )
            self._q_append(req)
            return displaced
        self._q_append(req)
        return []

    def _overshoots(self, for_tenant: str) -> Dict[str, int]:
        """Per-tenant queue overshoot beyond the fair caps — the entries
        displaceable in ``for_tenant``'s favor (never its own).  Caps are
        computed with the SUBMITTER counted as active: its very first
        request must already shrink a monopolist's share, or a full queue
        of tenant A would bounce tenant B forever."""
        if not self.fair or self.max_waiting <= 0:
            return {}
        active = self._active_tenants(extra=for_tenant)
        if len(active) <= 1:
            return {}
        total_w = sum(self.weight(t) for t in active)
        overshoot: Dict[str, int] = {}
        for t, depth in self._depths.items():
            if t == for_tenant:
                continue
            cap = self._share(self.max_waiting, t, total_w)
            over = depth - cap
            if over > 0:
                overshoot[t] = over
        return overshoot

    def displaceable(self, for_tenant: str) -> int:
        """How many queued entries could be displaced in ``for_tenant``'s
        favor right now — the engine's pre-flight twin of :meth:`_displace`
        (same cap arithmetic, so the 429 verdict and the submit outcome
        can never disagree)."""
        return sum(self._overshoots(for_tenant).values())

    def _displace(self, for_tenant: str) -> List[GenRequest]:
        """Evict the newest queued request of the most-over-share tenant
        (never ``for_tenant`` itself).  Returns [] when every other tenant
        is within its share — then the queue is legitimately full."""
        overshoot = self._overshoots(for_tenant)
        if not overshoot:
            return []
        # Deterministic victim: largest overshoot, tenant name as tiebreak.
        victim = max(overshoot, key=lambda t: (overshoot[t], t))
        for i in range(len(self.waiting) - 1, -1, -1):
            if self.waiting[i].tenant == victim:
                out = self.waiting[i]
                del self.waiting[i]
                self._q_forget(out)
                return [out]
        return []

    def slot_cap(self, tenant: str, active: List[str]) -> int:
        """Max decode slots ``tenant`` may HOLD while the given tenants are
        active: its weight fraction of ``num_slots``, floored at 1.

        This is the latency half of fairness (the queue cap is the buffer
        half): queue-order fairness alone cannot protect a victim tenant's
        TTFT once an aggressor's admitted streams occupy every slot —
        each stream holds its slot for the full decode, and the batch the
        victim eventually joins is as large (and as slow, on batch-scaled
        backends) as the aggressor made it.  Reserving the weighted slot
        share keeps headroom for every active tenant; a tenant with no
        work at all is not counted, so truly idle capacity still
        redistributes.
        """
        total_w = sum(self.weight(t) for t in active)
        return self._share(self.num_slots, tenant, total_w)

    def admit(self) -> List[RunningSlot]:
        """Move waiting requests into free slots. Returns admissions.

        Weighted-fair across tenants (stride order), FIFO within a tenant;
        with one ACTIVE tenant (queued or running) this IS the historical
        FIFO admit.  Under contention each tenant's running-slot count is
        additionally capped at its weight share (:meth:`slot_cap`); a
        capped tenant's backlog waits even if slots sit free — that
        headroom is precisely what keeps the other tenants' admission
        latency independent of the aggressor's backlog.
        """
        admitted: List[RunningSlot] = []
        if not self.waiting:
            return admitted
        if all(s is not None for s in self.slots):
            # Full decode batch: nothing can be admitted, so skip the
            # O(len(waiting)) caps scan below — under sustained overload
            # (600-deep queue, every slot busy) the engine loop calls
            # admit() each iteration and this is its hot path.
            return admitted
        active = self._active_tenants()
        fair = self.fair and len(active) > 1
        caps: Dict[str, int] = {}
        running: Dict[str, int] = {}
        if fair:
            # Pass records were minted at the idle→active edge in submit()
            # (_anchor_if_idle — the stride join rule); setdefault only
            # covers a fair-flag flip mid-flight.  Re-anchoring backlogged
            # tenants here would erase earned priority every round.
            for req in self.waiting:
                t = req.tenant
                if t not in caps:
                    self._pass.setdefault(t, self._vt)
                    caps[t] = self.slot_cap(t, active)
            for run in self.slots:
                if run is not None:
                    t = run.request.tenant
                    running[t] = running.get(t, 0) + 1
        for i in range(self.num_slots):
            if not self.waiting:
                break
            if self.slots[i] is not None:
                continue
            if fair:
                req = self._pop_fair(caps, running)
                if req is None:
                    break  # every backlogged tenant is at its slot share
                running[req.tenant] = running.get(req.tenant, 0) + 1
            else:
                req = self.waiting.popleft()
                self._q_forget(req)
            run = RunningSlot(req, i, cache_len=len(req.prompt_ids))
            self.slots[i] = run
            self._slots_dirty = True
            if self.page_reserve is not None:
                # Reserve prefix-pool pages for this admission;
                # the engine releases the grant when the insert lands or
                # on any death path (generate()'s finally).
                self.page_reserve(req)
            admitted.append(run)
        return admitted

    def _pop_fair(self, caps: Dict[str, int],
                  running: Dict[str, int]) -> Optional[GenRequest]:
        """Pop the head request of the smallest-stride-pass tenant still
        under its slot share (earliest queue position breaks ties —
        deterministic, and FIFO within a tenant by construction), or None
        when every backlogged tenant is at its cap."""
        best_idx = -1
        best_key = None
        seen: set = set()
        for idx, req in enumerate(self.waiting):
            if req.tenant in seen:
                continue  # only each tenant's FIFO head competes
            seen.add(req.tenant)
            if running.get(req.tenant, 0) >= caps[req.tenant]:
                continue
            key = (self._pass.get(req.tenant, self._vt), idx)
            if best_key is None or key < best_key:
                best_key, best_idx = key, idx
        if best_idx < 0:
            return None
        req = self.waiting[best_idx]
        del self.waiting[best_idx]
        self._q_forget(req)
        self._vt = self._pass.get(req.tenant, self._vt)
        self._pass[req.tenant] = self._vt + 1.0 / self.weight(req.tenant)
        return req

    # -- stepping ---------------------------------------------------------

    def active(self) -> List[RunningSlot]:
        return [s for s in self.slots if s is not None]

    def record_token(self, slot: int, token_id: int) -> RunningSlot:
        """Account one generated token; evicts the slot if finished."""
        run = self.slots[slot]
        assert run is not None, f"token for free slot {slot}"
        run.generated.append(token_id)
        run.cache_len += 1
        if run.done or run.cache_len >= self.max_seq:
            self.slots[slot] = None
            self._slots_dirty = True
        return run

    def cancel(self, request_id: int) -> bool:
        """Drop a request wherever it is (queue or slot)."""
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                self._q_forget(req)
                return True
        for i, run in enumerate(self.slots):
            if run is not None and run.request.request_id == request_id:
                self.slots[i] = None
                self._slots_dirty = True
                return True
        return False

    def expire(self, now: float) -> List[Tuple[Optional[int], GenRequest]]:
        """Evict every request whose deadline has passed.

        Returns ``(slot, request)`` pairs — ``slot`` is None for requests
        still waiting — in a deterministic order: waiting requests in FIFO
        order first, then running slots by slot index.  Deterministic
        ordering matters when a cancel and an expiry race within one engine
        step (tests/test_scheduler.py): the outcome must not depend on dict
        iteration order.
        """
        expired: List[Tuple[Optional[int], GenRequest]] = []
        keep: Deque[GenRequest] = deque()
        for req in self.waiting:
            if req.deadline is not None and now >= req.deadline:
                expired.append((None, req))
            else:
                keep.append(req)
        self.waiting = keep
        for _, req in expired:
            self._q_forget(req)
        for i, run in enumerate(self.slots):
            if run is None:
                continue
            d = run.request.deadline
            if d is not None and now >= d:
                self.slots[i] = None
                self._slots_dirty = True
                expired.append((i, run.request))
        return expired

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic state dump for the postmortem black box
       : the waiting queue and slot table as plain JSON-able
        rows.  Pure host reads — no clocks, so two seeded runs captured at
        the same logical point produce identical snapshots."""
        return {
            "queue_depth": len(self.waiting),
            "waiting": [
                {
                    "rid": req.request_id,
                    "tenant": req.tenant,
                    "prompt_tokens": len(req.prompt_ids),
                    "max_new_tokens": req.max_new_tokens,
                }
                for req in self.waiting
            ],
            "slots": [
                None if run is None else {
                    "rid": run.request.request_id,
                    "tenant": run.request.tenant,
                    "generated": len(run.generated),
                    "cache_len": run.cache_len,
                }
                for run in self.slots
            ],
            "virtual_time": round(self._vt, 6),
        }

    @property
    def occupancy(self) -> float:
        return sum(s is not None for s in self.slots) / self.num_slots

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def idle(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)
