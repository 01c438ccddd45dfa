"""The inference engine: prefill waves and pipelined decode bursts over a
slot-batched KV cache, in PyTorch (port of
p2p_llm_tunnel_tpu/engine/engine.py, the non-mux serving path).

Continuous batching as in the reference: the KV cache has ``num_slots``
fixed rows plus one scratch row; every decode burst runs ``steps`` decode
steps over all rows with on-device sampling feedback (inactive rows compute
but are parked out of range and masked at accounting); prompts prefill in
``prefill_rows``-wide waves padded to power-of-two length buckets, pad rows
writing into the scratch slot.

Async contract (unchanged): ``generate()`` yields TokenEvents as bursts
land; requests admit/evict between bursts; every tensor operation runs on
one dedicated executor thread so the tunnel's event loop never stalls.
Burst n is dispatched before burst n-1's tokens are fetched: the fetch
waits on a CUDA event recorded after burst n-1's device-to-host copy,
while the card already runs burst n.

What this slice does not port raises at construction (``EngineConfig``
knobs set away from their off value) or answers ``NotPorted`` (embeddings,
KV page export/import); ROADMAP.md lists each in the port queue.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.engine import sampling
from p2p_llm_tunnel_tpu_torch.engine.scheduler import (
    GenRequest,
    RunningSlot,
    Scheduler,
    TenantOverLimit,
    parse_tenant_weights,
)
from p2p_llm_tunnel_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    StreamDecoder,
    Tokenizer,
)
from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig, get_config
from p2p_llm_tunnel_tpu_torch.models.transformer import (
    NotPorted,
    decode_step,
    init_kv_cache,
    init_params,
    prefill_into_cache,
    resolve_device,
)
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.utils.flight import global_blackbox, global_flight
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.metrics import (
    derived_retry_after_s,
    global_metrics,
)
from p2p_llm_tunnel_tpu_torch.utils.slo import global_slo
from p2p_llm_tunnel_tpu_torch.utils.tracing import (
    TraceContext,
    global_tracer,
    new_span_id,
)

log = get_logger(__name__)

#: Queue sentinels (as in the reference): engine crashed, deadline
#: eviction, tenant-fair displacement.
_CRASHED = object()
_TIMED_OUT = object()
_SHED = object()

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class DeadlineExceeded(Exception):
    """The request's x-tunnel-deadline-ms budget ran out before completion."""

    #: Typed tunnel-error code (protocol.frames.TunnelMessage.typed_error).
    tunnel_code = "timeout"


@dataclass
class EngineConfig:
    """The reference's EngineConfig, field for field.

    Knobs this slice does not port must stay at their off value
    (``_UNPORTED``); construction raises otherwise.  ``flash_decode`` and
    ``flash_sgrid`` choose between XLA and Pallas on a TPU and choose
    nothing here: on the card the model layer always runs the two Hopper
    attention kernels, on the CPU their plain versions.
    """

    model: str = "tiny"
    num_slots: int = 8
    max_seq: int = 256
    dtype: str = "bfloat16"
    seed: int = 0
    min_prefill_bucket: int = 16
    # Decode steps per burst (on-device sampling feedback between steps).
    decode_steps: int = 8
    # Burst size while requests wait and an admission could land soon.
    decode_steps_eager: int = 4
    # Fixed row count per batched-prefill call (pad rows -> scratch slot).
    prefill_rows: int = 8
    tp: int = 1
    sp: int = 1
    sp_mode: str = "ring"
    ep: int = 1
    ckpt_path: Optional[str] = None
    quant: str = "none"
    quant_group_size: int = 128
    kv_quant: str = "none"
    flash_decode: bool = False
    flash_sgrid: bool = False
    fused_decode_layer: bool = False
    ragged_prefill: bool = False
    prefill_act_quant: bool = False
    prefix_cache: bool = False
    prefix_pool_blocks: int = 128
    prefix_cache_dir: Optional[str] = None
    prefix_tail_buckets: int = 2
    spec_ngram: int = 0
    spec_k: int = 4
    spec_k_max: int = 0
    prefill_chunk: int = 0
    # Admission control: max requests in the waiting queue (0 = unbounded).
    max_waiting: int = 0
    # Decode-stall watchdog budget in seconds (0 disables).
    watchdog_budget_s: float = 0.0
    mux: bool = False
    mux_budget_tokens: int = 0
    fair_admission: bool = True
    tenant_weights: str = ""
    conv_cache: bool = False
    prefix_evict: str = "cost"
    spill_pages: int = 0
    spill_low_water: int = 4
    role: str = "both"


#: knob -> (values that mean "off", ROADMAP.md port-queue item)
_UNPORTED = {
    "quant": (("none", ""), "quantized weights and KV"),
    "kv_quant": (("none", ""), "quantized weights and KV"),
    "prefill_act_quant": ((False,), "quantized weights and KV"),
    "mux": ((False,), "mux + prefix pool + conversation cache"),
    "prefix_cache": ((False,), "mux + prefix pool + conversation cache"),
    "conv_cache": ((False,), "mux + prefix pool + conversation cache"),
    "prefix_cache_dir": ((None, ""), "mux + prefix pool + conversation cache"),
    "prefill_chunk": ((0,), "chunk/ragged prefill (kernel 6)"),
    "ragged_prefill": ((False,), "chunk/ragged prefill (kernel 6)"),
    "fused_decode_layer": ((False,), "fused decode layer (kernel 4)"),
    "spec_ngram": ((0,), "spec decode (kernel 5)"),
    "spill_pages": ((0,), "spill/KV_PAGES"),
    "role": (("both",), "spill/KV_PAGES"),
    "ckpt_path": ((None, ""), "checkpoints and MoE"),
    "tp": ((1,), "parallel/"),
    "sp": ((1,), "parallel/"),
    "ep": ((1,), "parallel/"),
}


def check_ported(ecfg: EngineConfig) -> None:
    """Raise NotPorted naming the first knob set away from its off value."""
    for knob, (off, item) in _UNPORTED.items():
        val = getattr(ecfg, knob)
        if val not in off:
            raise NotPorted(f"EngineConfig.{knob}={val!r}", item)


@dataclass
class TokenEvent:
    token_id: int
    text: str
    finish_reason: Optional[str] = None  # "stop" | "length" on the last event
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None
    prompt_logprobs: Optional[List[float]] = None


@dataclass
class _ActiveRequest:
    queue: "asyncio.Queue[Optional[TokenEvent]]"
    decoder: StreamDecoder
    t_submit: float
    first_token_at: Optional[float] = None
    t_admitted: Optional[float] = None
    trace: Optional[TraceContext] = None
    trace_span: Optional[str] = None
    finish: Optional[str] = None


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


class _HostCopy:
    """Device results on their way to the host.  On the card the copy into
    pinned memory is enqueued right after the producing kernels and a CUDA
    event marks its end, so ``get()`` waits for exactly that work and no
    later burst; on the CPU the tensors are already host-side."""

    def __init__(self, tree):
        self.event = None
        cuda = [False]

        def start(x):
            if x.device.type != "cuda":
                return x
            cuda[0] = True
            dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            dst.copy_(x, non_blocking=True)
            return dst

        self.tree = _tree_map(start, tree)
        if cuda[0]:
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return _tree_map(lambda x: x.numpy(), self.tree)


class InferenceEngine:
    """Slot-batched continuous-decode engine over one model."""

    #: Max logit_bias entries per request (the reference's static cap).
    BIAS_CAP = 320

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        engine_cfg: Optional[EngineConfig] = None,
        params=None,
        tokenizer: Optional[Tokenizer] = None,
        device=None,
    ):
        self.ecfg = engine_cfg or EngineConfig()
        check_ported(self.ecfg)
        if self.ecfg.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {self.ecfg.sp_mode!r}")
        if self.ecfg.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.ecfg.dtype!r}")
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.mcfg = model_cfg or get_config(
            self.ecfg.model, vocab_size=self.tokenizer.vocab_size
        )
        dtype = _DTYPES[self.ecfg.dtype]
        if params is None:
            log.info("initialising random params for %s on %s",
                     self.mcfg.name, self.device)
            params = init_params(self.mcfg, self.ecfg.seed, dtype, self.device)
        self.params = params

        b, s = self.ecfg.num_slots, self.ecfg.max_seq
        # One extra cache row: the scratch slot that padded prefill rows
        # write into, so batched prefill never corrupts a live slot.
        rows = b + 1
        self._scratch_slot = b
        self.kv_cache = init_kv_cache(self.mcfg, rows, s, dtype,
                                      device=self.device)
        self.scheduler = Scheduler(
            b, s, max_waiting=self.ecfg.max_waiting,
            tenant_weights=parse_tenant_weights(self.ecfg.tenant_weights),
            fair=self.ecfg.fair_admission,
        )
        # Nothing is fenced at startup: unported knobs raise instead.
        self.config_fences: List[Dict[str, str]] = []
        global_metrics.set_info("config_fences", [])

        # Host-side per-slot state driving each decode burst.
        self._last_token = np.zeros((rows,), np.int32)
        self._positions = np.zeros((rows,), np.int32)
        self._active_mask = np.zeros((rows,), bool)
        self._temp = np.zeros((rows,), np.float32)
        self._top_k = np.zeros((rows,), np.int32)
        self._top_p = np.ones((rows,), np.float32)
        self._freq_pen = np.zeros((rows,), np.float32)
        self._pres_pen = np.zeros((rows,), np.float32)
        self._logprobs = np.zeros((rows,), np.int32)
        self._sample_seed = np.zeros((rows,), np.uint32)
        self._slot_bias_on = np.zeros((rows,), bool)
        self._ov_mask = np.zeros((rows,), bool)

        self._requests: Dict[int, _ActiveRequest] = {}
        self._next_request_id = 1
        # Unseeded draws only (every request gets a seed in generate()).
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.ecfg.seed + 1)
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._stop_lock = asyncio.Lock()
        self._stopped = False
        self._crashed = False
        self._warmup_done = False
        self._last_progress = time.monotonic()
        self._watchdog_task: Optional[asyncio.Task] = None
        self.degraded = False
        self.degraded_reason = ""
        self._flight_admitted = 0
        self._last_burst: Tuple[int, int] = (0, 0)
        global_blackbox.set_engine_provider(self._blackbox_state)
        # Dedicated single thread for every tensor operation.
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-torch"
        )
        # Per-slot OpenAI logit_bias plane [rows, V] (scratch row included).
        self._bias = torch.zeros((rows, self.mcfg.vocab_size),
                                 dtype=torch.float32, device=self.device)
        # Device-side decode carry (created lazily).
        self._dev_tokens: Optional[torch.Tensor] = None
        self._dev_positions: Optional[torch.Tensor] = None
        self._dev_counts: Optional[torch.Tensor] = None

    # -- device programs (executor thread) ---------------------------------

    def _host(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """A device COPY of a host array: the host mutates its arrays after
        dispatch, so the device must never alias them."""
        return torch.tensor(arr, dtype=dtype).to(self.device, non_blocking=True)

    def _decode_fn(self, ov_mask, ov_tok, ov_pos, samp: sampling.SamplingParams,
                   kv_view: int, steps: int):
        """``steps`` chained decode steps; sampled tokens feed back
        on-device.  The carry (tokens/positions/counts) stays on the device
        between bursts; ``ov_*`` patch rows the host changed since
        (admissions, parking) before stepping — including resetting that
        row's generated-token counts and crediting the prefill-sampled
        first token.  Returns (sampled [B,k], logprob tuple or None).

        The cache is updated IN PLACE by decode_step (the reference
        carried it through the scan functionally); rows parked at
        positions >= max_seq write nothing."""
        self._ensure_decode_carry()
        b = ov_tok.shape[0]
        tokens = torch.where(ov_mask, ov_tok, self._dev_tokens)
        positions = torch.where(ov_mask, ov_pos, self._dev_positions)
        counts = self._dev_counts
        any_pen = bool((samp.freq_pen != 0.0).any() or (samp.pres_pen != 0.0).any())
        rows = torch.arange(b, device=self.device)
        if any_pen:
            # In place, as the reference's reset_counts under its cond.
            counts.masked_fill_(ov_mask[:, None], 0)
            counts.index_put_((rows, ov_tok.long()), ov_mask.to(counts.dtype),
                              accumulate=True)
        any_lp = bool((samp.logprobs > 0).any())
        toks, lps = [], []
        for _ in range(steps):
            logits, _ = decode_step(
                self.mcfg, self.params, self.kv_cache, tokens, positions,
                kv_view=kv_view,
            )
            sampled = sampling.sample(logits, samp, self._gen, counts=counts,
                                      pos=positions + 1, bias=self._bias)
            if any_pen:
                counts.index_put_((rows, sampled.long()),
                                  torch.ones_like(sampled, dtype=counts.dtype),
                                  accumulate=True)
            if any_lp:
                lps.append(sampling.logprob_data(logits, sampled))
            toks.append(sampled)
            tokens, positions = sampled, positions + 1
        self._dev_tokens, self._dev_positions = tokens, positions
        lp_out = None
        if any_lp:
            lp_out = tuple(torch.stack([lp[j] for lp in lps], dim=1)
                           for j in range(3))  # [B, k], [B, k, W], [B, k, W]
        return torch.stack(toks, dim=1), lp_out

    def _prefill_fn(self, tokens, lengths, slots, samp, echo=False):
        """Plain prefill of one wave into its slots (cache written IN
        PLACE) and the first sampled token per row."""
        prompt_lps = None
        if echo:
            last_logits, _, prompt_lps = prefill_into_cache(
                self.mcfg, self.params, tokens, lengths, self.kv_cache, slots,
                return_prompt_logprobs=True,
            )
        else:
            last_logits, _ = prefill_into_cache(
                self.mcfg, self.params, tokens, lengths, self.kv_cache, slots,
            )
        # Prefill rows are packed; each row reads its SLOT's bias plane.
        first = sampling.sample(last_logits, samp, self._gen, pos=lengths,
                                bias=self._bias[slots])
        lp = None
        if (samp.logprobs > 0).any():
            lp = sampling.logprob_data(last_logits, first)
        return first, lp, prompt_lps

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._running = True
            self._stopped = False
            self._task = asyncio.create_task(self._loop())
            if self.ecfg.watchdog_budget_s > 0:
                self._watchdog_task = asyncio.create_task(self._watchdog())

    async def _watchdog(self) -> None:
        """Flag (never interrupt) a stalled decode path; observes host
        state only, so it keeps ticking while the loop is wedged."""
        budget = self.ecfg.watchdog_budget_s
        while self._running:
            await asyncio.sleep(min(1.0, budget / 4))
            busy = bool(self._requests)
            stalled = time.monotonic() - self._last_progress > budget
            if busy and stalled:
                if not self.degraded:
                    phase = global_flight.current_phase()
                    log.error(
                        "decode-stall watchdog: no token accounted in "
                        "%.1fs with %d request(s) in flight; marking "
                        "engine degraded (stalled in loop phase %r)",
                        budget, len(self._requests), phase,
                    )
                    global_metrics.inc("engine_watchdog_stalls_total")
                    self.degraded = True
                    self.degraded_reason = "watchdog"
                    global_metrics.set_info("engine_degraded_reason", "watchdog")
                    global_metrics.set_gauge("engine_degraded", 1.0)
                    global_blackbox.capture("watchdog", attribution=phase)
            elif self.degraded and not stalled:
                log.info("decode-stall watchdog: progress resumed")
                self.degraded = False
                self.degraded_reason = ""
                global_metrics.set_info("engine_degraded_reason", "")
            global_metrics.set_gauge(
                "engine_degraded", 1.0 if self.degraded else 0.0
            )

    async def stop(self) -> None:
        self._running = False
        self._wake.set()
        async with self._stop_lock:
            if self._stopped:
                return
            if self._watchdog_task is not None:
                self._watchdog_task.cancel()
                try:
                    await self._watchdog_task
                except asyncio.CancelledError:
                    pass
                self._watchdog_task = None
            if self._task is not None:
                try:
                    await self._task
                except asyncio.CancelledError:
                    pass
                except Exception:
                    # Already logged and surfaced to consumers by the
                    # loop's crash containment.
                    pass
                self._task = None
            for state in list(self._requests.values()):
                state.queue.put_nowait(None)
            self._executor.shutdown(wait=False)
            self._stopped = True

    async def warmup(self) -> None:
        """Build the CUDA kernels (nvcc, at first use) and run one decode
        burst and one prefill wave before serving, so no request pays for
        either.  Eager PyTorch compiles nothing per shape, so unlike the
        reference's per-bucket program grid one of each suffices."""
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        if self.device.type == "cuda":
            await loop.run_in_executor(self._executor, kernel_build.build)
        await loop.run_in_executor(self._executor, self._warm_decode)
        await loop.run_in_executor(self._executor, self._warm_prefill)
        global_metrics.set_gauge("engine_warmup_compile_s",
                                 time.monotonic() - t0)
        self._warmup_done = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _warm_decode(self) -> None:
        """One burst with every row parked: writes nothing."""
        self._dispatch_decode(view=self._view_buckets()[0])
        self._sync()

    @torch.inference_mode()
    def _warm_prefill(self) -> None:
        """One prefill wave of pad rows into the scratch slot."""
        nb = self.ecfg.prefill_rows
        rows = np.zeros((nb,), np.int32)
        self._prefill_fn(
            self._host(np.zeros((nb, self._bucket(1)), np.int32)),
            self._host(np.ones((nb,), np.int32)),
            self._host(np.full((nb,), self._scratch_slot, np.int64)),
            sampling.SamplingParams(
                rows.astype(np.float32), rows, np.ones((nb,), np.float32),
                rows.astype(np.float32), rows.astype(np.float32), rows,
                rows.astype(np.uint32), rows.astype(bool),
            ),
        )
        self._sync()

    def _blackbox_state(self) -> dict:
        """Engine section of a postmortem bundle: pure host reads."""
        from dataclasses import asdict

        return {
            "config": asdict(self.ecfg),
            "model": self.mcfg.name,
            "device": str(self.device),
            "scheduler": self.scheduler.snapshot(),
            "requests_in_flight": len(self._requests),
            "config_fences": list(self.config_fences),
            "degraded": self.degraded,
            "degraded_reason": self.degraded_reason,
            "crashed": self._crashed,
            "warmup_done": self._warmup_done,
        }

    # -- admission surface ---------------------------------------------------

    def admission_check(self, n: int = 1, tenant: str = "") -> Optional[str]:
        """Pre-flight admission verdict: None (admit), ``"busy"`` or
        ``"tenant_overlimit"`` — the reference's queue arithmetic (this
        slice has no KV pool, so never ``"memory"``)."""
        mw = self.ecfg.max_waiting
        if mw <= 0:
            return None
        sched = self.scheduler
        cap = sched.fair_cap(tenant)
        if cap is not None and sched.tenant_queue_depth(tenant) + n > cap:
            return "tenant_overlimit"
        if sched.queue_depth + n > mw:
            need = sched.queue_depth + n - mw
            if (self.ecfg.fair_admission
                    and sched.displaceable(tenant) >= need):
                return None
            return "busy"
        return None

    def retry_after_s(self) -> float:
        """Advisory Retry-After for a 429 from the live queue."""
        return derived_retry_after_s(
            self.scheduler.queue_depth, "engine_admissions_total",
            "engine_retry_after_s",
        )

    async def embed(self, prompts: List[List[int]]) -> np.ndarray:
        raise NotPorted("embeddings", "embeddings")

    async def export_kv_pages(self, prompt_ids) -> Optional[Dict]:
        raise NotPorted("KV page export", "spill/KV_PAGES")

    async def import_kv_pages(self, meta: Dict, pages: List[Dict],
                              blobs: List[bytes]) -> int:
        raise NotPorted("KV page import", "spill/KV_PAGES")

    def disagg_stats(self) -> Dict[str, object]:
        """/healthz ``disagg`` section: this engine always serves both
        roles and moves no pages."""
        return {"role": self.ecfg.role, "pages_shipped": 0,
                "pages_spliced": 0, "xfer_inflight": 0}

    async def generate(
        self,
        prompt_ids: List[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        freq_pen: float = 0.0,
        pres_pen: float = 0.0,
        logprobs: int = 0,
        echo_logprobs: bool = False,
        stop_ids: Optional[Tuple[int, ...]] = None,
        seed: Optional[int] = None,
        logit_bias: Tuple[Tuple[int, float], ...] = (),
        deadline: Optional[float] = None,
        trace: Optional[TraceContext] = None,
        tenant: str = "",
    ) -> AsyncIterator[TokenEvent]:
        """Submit one request; yields TokenEvents as the batch decodes
        (the reference's contract: deadlines evict and raise
        DeadlineExceeded, tenant displacement raises TenantOverLimit)."""
        if self._crashed:
            raise RuntimeError("engine loop crashed; restart the serve process")
        if len(logit_bias) > self.BIAS_CAP:
            raise ValueError(
                f"logit_bias supports at most {self.BIAS_CAP} entries"
            )
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded("deadline already expired at submit")
        if stop_ids is None:
            stop_ids = (self.tokenizer.eos_id,)
        rid = self._next_request_id
        self._next_request_id += 1
        if seed is None:
            # Auto-seed from the request id: reproducible for a fixed
            # submission order AND independent of batch composition.
            seed = (rid * 2654435761 + self.ecfg.seed) & 0xFFFFFFFF
        req = GenRequest(
            request_id=rid,
            seed=int(seed) & 0xFFFFFFFF,
            logit_bias=tuple(logit_bias),
            prompt_ids=list(prompt_ids),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            freq_pen=freq_pen,
            pres_pen=pres_pen,
            logprobs=logprobs,
            echo_logprobs=echo_logprobs,
            stop_ids=tuple(stop_ids),
            deadline=deadline,
            tenant=tenant,
        )
        state = _ActiveRequest(
            queue=asyncio.Queue(), decoder=StreamDecoder(self.tokenizer),
            t_submit=time.monotonic(),
        )
        if trace is not None and global_tracer.on(trace.trace_id):
            state.trace = trace
            state.trace_span = new_span_id()
        self._requests[rid] = state
        try:
            displaced = self.scheduler.submit(req)
        except TenantOverLimit:
            self._requests.pop(rid, None)
            global_metrics.tenant_shed(tenant)
            raise
        except Exception:
            self._requests.pop(rid, None)
            raise
        for dreq in displaced:
            d_state = self._requests.get(dreq.request_id)
            if d_state is not None:
                d_state.queue.put_nowait(_SHED)
            global_metrics.tenant_shed(dreq.tenant)
        global_metrics.tenant_begin(tenant)
        global_metrics.set_gauge("engine_queue_depth", self.scheduler.queue_depth)
        self._wake.set()

        try:
            while True:
                event = await state.queue.get()
                if event is _CRASHED:
                    state.finish = "crashed"
                    raise RuntimeError("engine crashed mid-generation")
                if event is _TIMED_OUT:
                    state.finish = "timeout"
                    raise DeadlineExceeded("deadline exceeded; request evicted")
                if event is _SHED:
                    state.finish = "shed"
                    raise TenantOverLimit(
                        "displaced by tenant-fair admission; retry after "
                        "backing off"
                    )
                if event is None:
                    return
                if event.finish_reason is not None:
                    state.finish = event.finish_reason
                yield event
                if event.finish_reason is not None:
                    return
        finally:
            self._requests.pop(rid, None)
            self.scheduler.cancel(rid)
            global_metrics.tenant_end(tenant)
            if state.first_token_at is None and state.finish:
                # Ended server-side without a first token: a bad TTFT event.
                global_slo.record("ttft", False)
            if state.trace is not None:
                t_end = time.monotonic()
                global_tracer.add_event(
                    "engine.stream_end", trace_id=state.trace.trace_id,
                    parent_id=state.trace_span, track="engine", t=t_end,
                )
                attrs = {"rid": rid, "finish": state.finish or "cancelled"}
                if tenant:
                    attrs["tenant"] = tenant
                global_tracer.add_span(
                    "engine.request", trace_id=state.trace.trace_id,
                    span_id=state.trace_span,
                    parent_id=state.trace.span_id or None, track="engine",
                    t0=state.t_submit, t1=t_end, attrs=attrs,
                )

    # -- engine loop ---------------------------------------------------------

    def _emit(self, run: RunningSlot, token_id: int, evicted: bool,
              lp_info=None, prompt_lps=None) -> None:
        rid = run.request.request_id
        state = self._requests.get(rid)
        if state is None:
            return  # consumer went away; scheduler cancel happens in generate()
        if state.first_token_at is None:
            state.first_token_at = time.monotonic()
            ttft_ms = (state.first_token_at - state.t_submit) * 1000.0
            global_metrics.observe("engine_ttft_ms", ttft_ms)
            global_slo.record_latency("ttft", ttft_ms)
            if state.t_admitted is not None:
                global_metrics.observe(
                    "engine_prefill_exec_ms",
                    (state.first_token_at - state.t_admitted) * 1000.0,
                )
            if state.trace is not None:
                tid = state.trace.trace_id
                if state.t_admitted is not None:
                    global_tracer.add_span(
                        "engine.queue_wait", trace_id=tid,
                        parent_id=state.trace_span, track="engine",
                        t0=state.t_submit, t1=state.t_admitted,
                    )
                    global_tracer.add_span(
                        "engine.prefill_exec", trace_id=tid,
                        parent_id=state.trace_span, track="engine",
                        t0=state.t_admitted, t1=state.first_token_at,
                    )
                global_tracer.add_event(
                    "engine.first_token", trace_id=tid,
                    parent_id=state.trace_span, track="engine",
                    t=state.first_token_at,
                )
        global_metrics.inc("engine_tokens_total")
        if run.request.tenant:
            global_metrics.tenant_tokens(run.request.tenant)
            self.scheduler.charge_tokens(run.request.tenant, 1)
        is_stop = token_id in run.request.stop_ids
        finish = None
        if evicted:
            finish = "stop" if is_stop else "length"
        text = "" if is_stop else state.decoder.push(token_id)
        logprob = tops = None
        if lp_info is not None and run.request.logprobs > 0 and not is_stop:
            chosen, top_ids, top_lps = lp_info
            logprob = float(chosen)
            n = min(run.request.logprobs, len(top_ids))
            tops = [(int(top_ids[j]), float(top_lps[j])) for j in range(n)]
        state.queue.put_nowait(
            TokenEvent(token_id, text, finish, logprob, tops, prompt_lps)
        )

    def _bucket(self, n: int) -> int:
        b = self.ecfg.min_prefill_bucket
        while b < n:
            b *= 2
        return min(b, self.ecfg.max_seq)

    @torch.inference_mode()
    def _dispatch_prefill_batch(self, runs: List[RunningSlot], t: int,
                                echo: bool = False) -> _HostCopy:
        """Dispatch one wave of admitted prompts (bucket width ``t``) and
        start the copy of its first tokens to the host WITHOUT waiting for
        it; rows are padded to ``prefill_rows``, pad rows write the
        scratch slot."""
        n = len(runs)
        nb = max(self.ecfg.prefill_rows, n)
        tokens = np.zeros((nb, t), np.int32)
        lengths = np.ones((nb,), np.int32)
        slots = np.full((nb,), self._scratch_slot, np.int64)
        temp = np.zeros((nb,), np.float32)
        top_k = np.zeros((nb,), np.int32)
        top_p = np.ones((nb,), np.float32)
        lps = np.zeros((nb,), np.int32)
        seeds = np.zeros((nb,), np.uint32)
        bias_on = np.zeros((nb,), bool)
        total = 0
        for i, run in enumerate(runs):
            ids = run.request.prompt_ids
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
            slots[i] = run.slot
            temp[i] = run.request.temperature
            top_k[i] = run.request.top_k
            top_p[i] = run.request.top_p
            lps[i] = run.request.logprobs
            seeds[i] = run.request.seed
            bias_on[i] = bool(run.request.logit_bias)
            total += len(ids)
        self._apply_logit_bias(runs)
        # Penalties are zero here: the FIRST token has no generated
        # predecessors.
        zeros = np.zeros((nb,), np.float32)
        samp = sampling.SamplingParams(temp, top_k, top_p, zeros, zeros,
                                       lps, seeds, bias_on)
        first, lp, plp = self._prefill_fn(
            self._host(tokens), self._host(lengths), self._host(slots),
            samp, echo,
        )
        global_metrics.inc("engine_prefill_tokens_total", total)
        return _HostCopy((first, lp, plp))

    def _view_buckets(self) -> List[int]:
        """kv-view buckets: powers of two from 128 up, clamped to max_seq."""
        buckets = []
        v = 128
        while v < self.ecfg.max_seq:
            buckets.append(v)
            v *= 2
        buckets.append(self.ecfg.max_seq)
        return sorted(set(buckets))

    def _kv_view_bucket(self) -> int:
        """Smallest bucket covering every active slot, padded by two bursts
        (the device carry can run up to two bursts ahead of the host)."""
        n = self.ecfg.num_slots
        active = self._active_mask[:n]
        need = 1
        if active.any():
            need = int(self._positions[:n][active].max()) + 1
        need += 2 * self.ecfg.decode_steps + 1
        for view in self._view_buckets():
            if view >= need:
                return view
        return self.ecfg.max_seq

    def _burst_steps(self) -> int:
        """Full burst normally; the eager burst while work waits AND an
        admission could land soon (a free slot, or one finishing within a
        full burst)."""
        eager = self.ecfg.decode_steps_eager
        if not (eager and 0 < eager < self.ecfg.decode_steps):
            return self.ecfg.decode_steps
        if self.scheduler.queue_depth == 0:
            return self.ecfg.decode_steps
        full = self.ecfg.decode_steps
        for run in self.scheduler.slots:
            if run is None:
                return eager
            if run.request.max_new_tokens - len(run.generated) <= full:
                return eager
        return full

    @torch.inference_mode()
    def _dispatch_decode(self, *, view: Optional[int] = None,
                         steps: Optional[int] = None):
        """Dispatch one burst and start its host copy; returns
        (_HostCopy, per-row request-id snapshot) without waiting."""
        active = self._active_mask
        # Controls are COPIES: the host mutates its arrays right after.
        samp = sampling.SamplingParams(
            temperature=self._temp.copy(),
            top_k=self._top_k.copy(),
            top_p=self._top_p.copy(),
            freq_pen=np.where(active, self._freq_pen, 0.0).astype(np.float32),
            pres_pen=np.where(active, self._pres_pen, 0.0).astype(np.float32),
            logprobs=np.where(active, self._logprobs, 0).astype(np.int32),
            seed=self._sample_seed.copy(),
            bias_on=self._slot_bias_on & active,
        )
        # INACTIVE rows are parked at position max_seq every dispatch: the
        # decode step drops their cache writes, so a stale carry can never
        # write into a slot a later prefill owns.
        inactive = ~active
        ov_mask = self._ov_mask | inactive
        ov_pos = np.where(inactive, self.ecfg.max_seq, self._positions)
        view = self._kv_view_bucket() if view is None else view
        steps = self._burst_steps() if steps is None else steps
        sampled, lp_out = self._decode_fn(
            self._host(ov_mask), self._host(self._last_token),
            self._host(ov_pos.astype(np.int32)), samp, view, steps,
        )
        self._last_burst = (
            steps, int(np.count_nonzero(active[: self.ecfg.num_slots]))
        )
        self._ov_mask[:] = False  # patch consumed by this dispatch
        assign = [
            run.request.request_id
            if run is not None and self._active_mask[i] else None
            for i, run in enumerate(self.scheduler.slots)
        ] + [None]  # scratch row
        return _HostCopy((sampled, lp_out)), assign

    def _ensure_decode_carry(self) -> None:
        if self._dev_tokens is not None:
            return
        rows = self.ecfg.num_slots + 1
        self._dev_tokens = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        self._dev_positions = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        self._dev_counts = torch.zeros((rows, self.mcfg.vocab_size),
                                       dtype=torch.int32, device=self.device)

    def _apply_logit_bias(self, runs) -> None:
        """Write admitted requests' logit_bias rows into the device plane
        (executor thread); slots whose previous occupant had a bias are
        cleared lazily."""
        for run in runs:
            i = run.slot
            lb = run.request.logit_bias
            if not lb and not self._slot_bias_on[i]:
                continue
            self._bias[i].zero_()
            if lb:
                ids = self._host(np.array([t for t, _ in lb[: self.BIAS_CAP]], np.int64))
                vals = self._host(np.array([v for _, v in lb[: self.BIAS_CAP]], np.float32))
                self._bias[i].index_add_(0, ids, vals)
            self._slot_bias_on[i] = bool(lb)

    def _admit_one(self, run: RunningSlot) -> None:
        """Set up host slot state after prefill admission."""
        i = run.slot
        req = run.request
        self._active_mask[i] = True
        self._positions[i] = run.cache_len
        self._temp[i] = req.temperature
        self._top_k[i] = req.top_k
        self._top_p[i] = req.top_p
        self._freq_pen[i] = req.freq_pen
        self._pres_pen[i] = req.pres_pen
        self._logprobs[i] = req.logprobs
        self._sample_seed[i] = req.seed
        # The device carry knows nothing about this slot yet: patch it in
        # at the next dispatch.
        self._ov_mask[i] = True

    def _expire_deadlines(self) -> None:
        """Evict deadline-blown requests (queue or slot) and fail their
        consumers with DeadlineExceeded; once per loop iteration."""
        expired = self.scheduler.expire(time.monotonic())
        for slot, req in expired:
            if slot is not None:
                self._active_mask[slot] = False
            global_metrics.inc("engine_deadline_timeouts_total")
            log.warning(
                "request %d exceeded its deadline (%s); slot reclaimed",
                req.request_id,
                "waiting" if slot is None else f"slot {slot}",
            )
            state = self._requests.get(req.request_id)
            if state is not None:
                if state.trace is not None:
                    global_tracer.add_event(
                        "engine.deadline_evict",
                        trace_id=state.trace.trace_id,
                        parent_id=state.trace_span, track="engine",
                        attrs={"where": "waiting" if slot is None
                               else f"slot {slot}"},
                    )
                state.queue.put_nowait(_TIMED_OUT)

    def _account_token(self, slot: int, tok: int, lp_info=None,
                       prompt_lps=None) -> None:
        """Record one generated token: scheduler accounting, slot-state
        update for the next burst, eviction, emission."""
        self._last_progress = time.monotonic()
        out = self.scheduler.record_token(slot, tok)
        evicted = self.scheduler.slots[slot] is None
        if evicted:
            self._active_mask[slot] = False
        else:
            self._last_token[slot] = tok
            # The generated token's own position: the decode step that
            # consumes it writes it to the cache.
            self._positions[slot] = out.cache_len - 1
        self._emit(out, tok, evicted, lp_info, prompt_lps)

    async def _admit_pending(self, loop) -> None:
        """Admit what the scheduler allows and prefill it: every wave is
        DISPATCHED first, then fetched in dispatch order, so wave n+1
        computes while wave n's first tokens travel to the host."""
        admitted = self.scheduler.admit()
        if not admitted:
            return
        now = time.monotonic()
        global_metrics.inc("engine_admissions_total", len(admitted))
        self._flight_admitted += len(admitted)
        for run in admitted:
            st = self._requests.get(run.request.request_id)
            if st is not None and st.t_admitted is None:
                st.t_admitted = now
                global_metrics.observe(
                    "engine_queue_wait_ms", (now - st.t_submit) * 1000.0
                )
        groups: Dict[Tuple[int, bool], List[RunningSlot]] = {}
        for run in admitted:
            t = self._bucket(len(run.request.prompt_ids))
            groups.setdefault((t, bool(run.request.echo_logprobs)), []).append(run)
        pr = self.ecfg.prefill_rows
        dispatched = []
        for (t, echo), runs in sorted(groups.items()):
            for i in range(0, len(runs), pr):
                wave = runs[i : i + pr]
                t0 = time.monotonic()
                pending = await loop.run_in_executor(
                    self._executor, self._dispatch_prefill_batch, wave, t, echo,
                )
                dispatched.append((wave, pending, t0))
        for runs, pending, t0 in dispatched:
            firsts, lp, plp = await loop.run_in_executor(
                self._executor, pending.get
            )
            global_metrics.observe(
                "engine_prefill_ms", (time.monotonic() - t0) * 1000.0
            )
            for i, run in enumerate(runs):
                if self.scheduler.slots[run.slot] is not run:
                    continue  # consumer cancelled while the wave was in flight
                self._admit_one(run)
                lp_row = None if lp is None else (lp[0][i], lp[1][i], lp[2][i])
                plp_row = None
                if plp is not None:
                    n = len(run.request.prompt_ids)
                    plp_row = [float(x) for x in plp[i][:n]]
                self._account_token(run.slot, int(firsts[i]), lp_row, plp_row)

    async def _process_burst(self, outs, assign: List) -> None:
        """Account one fetched token block [R, k] against current
        occupants; rows freed or re-admitted since dispatch are skipped."""
        sampled, lp_out = outs
        for col in range(sampled.shape[1]):
            for i in np.nonzero(self._active_mask)[0]:
                run = self.scheduler.slots[i] if i < self.ecfg.num_slots else None
                if run is None:  # cancelled/evicted since dispatch
                    self._active_mask[i] = False
                    continue
                if run.request.request_id != assign[i]:
                    continue  # re-admitted: its tokens come from the next burst
                lp_row = None
                if lp_out is not None:
                    lp, top_ids, top_lps = lp_out
                    lp_row = (lp[i, col], top_ids[i, col], top_lps[i, col])
                self._account_token(int(i), int(sampled[i, col]), lp_row)
            # Flush this column's tokens to consumers before the next.
            await asyncio.sleep(0)

    def _trace_burst(self, t_dispatch: float, assign: List) -> None:
        if not global_tracer.enabled:
            return
        global_tracer.add_span(
            "engine.decode_burst", trace_id=None, track="engine-loop",
            t0=t_dispatch,
            attrs={"rows": sum(1 for a in assign if a is not None)},
        )

    def _flight_record(self, it_t0: float, t_admit: float,
                       t_dispatch: float, t_fetch: float,
                       plain_rows: int) -> None:
        """One flight-recorder row per non-idle loop iteration."""
        now = time.monotonic()
        slots = self.scheduler.slots
        global_flight.record_iteration(
            t=it_t0,
            dur_ms=round((now - it_t0) * 1000.0, 3),
            queue_depth=self.scheduler.queue_depth,
            backlog_rows=0,
            budget_tokens=0,
            admitted=self._flight_admitted,
            prefill_rows=plain_rows,
            decode_steps=self._last_burst[0],
            decode_rows=self._last_burst[1],
            active_slots=sum(1 for s in slots if s is not None),
            tenants=len({run.request.tenant for run in slots if run is not None}),
            cold_compiles=0,
            admit_ms=round((t_admit - it_t0) * 1000.0, 3),
            prefill_ms=0.0,
            dispatch_ms=round((t_dispatch - t_admit) * 1000.0, 3),
            fetch_ms=round((t_fetch - t_dispatch) * 1000.0, 3),
            process_ms=round((now - t_fetch) * 1000.0, 3),
        )

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        log.info(
            "engine loop started: model=%s slots=%d max_seq=%d decode_steps=%d "
            "device=%s", self.mcfg.name, self.ecfg.num_slots,
            self.ecfg.max_seq, self.ecfg.decode_steps, self.device,
        )
        # Crash containment: a dispatch exception surfaces loudly and
        # unblocks every consumer.
        try:
            in_flight = None  # (_HostCopy, request-id snapshot, dispatch instant)
            while self._running:
                if self.scheduler.idle and in_flight is None:
                    global_flight.set_phase("idle")
                    self._last_progress = time.monotonic()
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=0.5)
                    except asyncio.TimeoutError:
                        continue
                    continue

                it_t0 = time.monotonic()
                self._flight_admitted = 0
                self._last_burst = (0, 0)
                global_flight.set_phase("admit")
                self._expire_deadlines()
                # Whole-prompt admission waves run inline: their rows are
                # this iteration's prefill work.
                await self._admit_pending(loop)
                plain_rows = self._flight_admitted
                t_admit = time.monotonic()
                global_metrics.set_gauge("engine_batch_occupancy",
                                         self.scheduler.occupancy)
                global_metrics.set_gauge("engine_queue_depth",
                                         self.scheduler.queue_depth)

                # Pipeline: dispatch burst n, THEN fetch burst n-1 — the
                # fetch waits only for burst n-1 while burst n runs.
                current = None
                global_flight.set_phase("decode_dispatch")
                if any(self._active_mask):
                    t_disp0 = time.monotonic()
                    pending0, assign0 = await loop.run_in_executor(
                        self._executor, self._dispatch_decode
                    )
                    current = (pending0, assign0, t_disp0)
                t_dispatch = time.monotonic()
                global_flight.set_phase("decode_fetch")
                if in_flight is not None:
                    pending, assign, t_disp = in_flight
                    t0 = time.monotonic()
                    outs = await loop.run_in_executor(self._executor, pending.get)
                    global_metrics.observe(
                        "engine_decode_fetch_ms", (time.monotonic() - t0) * 1000.0
                    )
                    t_fetch = time.monotonic()
                    global_flight.set_phase("process")
                    await self._process_burst(outs, assign)
                    self._trace_burst(t_disp, assign)
                else:
                    t_fetch = t_dispatch
                in_flight = current
                self._flight_record(it_t0, t_admit, t_dispatch, t_fetch,
                                    plain_rows)
        except Exception:
            log.exception(
                "engine loop crashed; failing %d in-flight requests",
                len(self._requests),
            )
            global_blackbox.capture(
                "crash", attribution=global_flight.current_phase(),
            )
            self._running = False
            self._crashed = True  # generate() rejects new submissions
            for state in list(self._requests.values()):
                state.queue.put_nowait(_CRASHED)
            raise
        log.info("engine loop stopped")
