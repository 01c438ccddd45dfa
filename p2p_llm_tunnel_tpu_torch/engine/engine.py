"""The inference engine: prefill waves, chunked prefill segments and
pipelined decode bursts over a slot-batched KV cache, in PyTorch (port of
p2p_llm_tunnel_tpu/engine/engine.py: the serve CLI's default engine —
mux, prefix pool and conversation cache — and the plain non-mux loop, with
a raw, int8 or packed-int4 KV cache and the unfused or fused decode
layer).

Continuous batching as in the reference: the KV cache has ``num_slots``
fixed rows plus one scratch row; every decode burst runs ``steps`` decode
steps over all rows with on-device sampling feedback (inactive rows compute
but are parked out of range and masked at accounting); prompts prefill in
``prefill_rows``-wide waves padded to power-of-two length buckets, pad rows
writing into the scratch slot.  With ``prefill_chunk`` long prompts advance
one segment per loop iteration (``chunk_prefill_into_cache``); under
``mux`` each iteration dispatches one decode burst plus a token budget of
segment rows (``scheduler.MuxController``), and with the prefix cache a
shared not-yet-pooled prefix is prefilled once by its first requester while
later ones park and fan out from the pool (``engine/prefix_cache.py``).
``ragged_prefill`` routes every chunk dispatch through the ragged grouped
kernel instead (``ragged_prefill_into_cache``); ``kv_quant`` stores the KV
cache (and the pool's pages) as int8 or packed int4 with per-(token, head)
scales; ``fused_decode_layer`` runs each decode layer's attention
sub-block as one kernel-4 launch.  ``spec_ngram`` turns on prompt-lookup
speculative decoding: each iteration proposes up to K continuation tokens
per slot from its own history and verifies them in one synchronous burst
(``spec_verify_into_cache``: kernel 5 under the fused decode layer, the
chunk path otherwise), accepting the greedy-matching prefix plus one bonus
token — greedy streams are those of plain decode.

Async contract (unchanged): ``generate()`` yields TokenEvents as bursts
land; requests admit/evict between bursts; every tensor operation runs on
one dedicated executor thread so the tunnel's event loop never stalls.
Burst n is dispatched before burst n-1's tokens are fetched: the fetch
waits on a CUDA event recorded after burst n-1's device-to-host copy,
while the card already runs burst n.

What this port does not run yet raises at construction (``EngineConfig``
knobs set away from their off value) or answers ``NotPorted`` (embeddings,
KV page export/import); ROADMAP.md lists each in the port queue.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import math
import time
from collections import deque
from dataclasses import dataclass, replace as dc_replace
from typing import AsyncIterator, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.engine import sampling
from p2p_llm_tunnel_tpu_torch.engine.prefix_cache import (
    PrefixIndex,
    init_pool,
    make_batch_copy_ops,
    pad_rows,
    plan_group_admission,
    plan_inserts,
    pool_packed_keys,
)
from p2p_llm_tunnel_tpu_torch.engine.scheduler import (
    GenRequest,
    MuxController,
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
    chunk_prefill_into_cache,
    decode_step,
    init_kv_cache,
    init_params,
    prefill_into_cache,
    ragged_prefill_into_cache,
    resolve_device,
    spec_verify_into_cache,
)
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops.prefill_attention import plan_ragged_group
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
    """The reference's EngineConfig, field for field and default for
    default: mux, prefix cache and conversation cache are off here and ON
    in the serve CLI, as in the reference.

    Knobs the port does not run yet must stay at their off value
    (``_UNPORTED``); construction raises otherwise.  ``flash_decode`` and
    ``flash_sgrid`` choose between XLA and Pallas on a TPU and choose
    nothing here: on the card the model layer always runs the Hopper
    attention kernels, on the CPU their plain versions.
    ``ragged_prefill`` keeps its reference meaning: it routes every chunk
    dispatch through the ragged grouped kernel; off, chunk dispatches run
    ``chunk_prefill_into_cache``'s einsum attention on either device.
    ``kv_quant`` ("none" | "int8" | "int4") and ``fused_decode_layer``
    keep theirs too (the cache's storage form; kernel 4 for decode, kernel 5
    for verify bursts), as do ``spec_ngram`` (the proposer's match length,
    0 = off), ``spec_k`` (proposals per burst) and ``spec_k_max`` (the
    adaptive burst-width cap; 0 = fixed ``spec_k``).
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
    "quant": (("none", ""), "weight quantization"),
    "prefill_act_quant": ((False,), "weight quantization"),
    "prefix_cache_dir": ((None, ""), "spill tier, snapshots and KV_PAGES"),
    "spill_pages": ((0,), "spill tier, snapshots and KV_PAGES"),
    "role": (("both",), "spill tier, snapshots and KV_PAGES"),
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
    t_parked: Optional[float] = None  # prefix-group park start (waiters)
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
        if self.ecfg.kv_quant not in ("none", "", "int8", "int4"):
            raise ValueError(f"unknown kv_quant mode {self.ecfg.kv_quant!r}")
        # One-directional promotion into the model config, as the reference.
        if self.ecfg.fused_decode_layer and not self.mcfg.fused_decode_layer:
            self.mcfg = dc_replace(self.mcfg, fused_decode_layer=True)
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
                                      quant=self.ecfg.kv_quant,
                                      device=self.device)
        self.scheduler = Scheduler(
            b, s, max_waiting=self.ecfg.max_waiting,
            tenant_weights=parse_tenant_weights(self.ecfg.tenant_weights),
            fair=self.ecfg.fair_admission,
        )
        if self.ecfg.prefix_evict not in ("cost", "lru"):
            raise ValueError(
                f"unknown prefix_evict mode {self.ecfg.prefix_evict!r}"
            )
        # Composition-fence registry: every knob the engine auto-disables
        # at startup lands here WITH its reason (the /healthz "config"
        # section); unported knobs raise instead.
        self.config_fences: List[Dict[str, str]] = []
        # Conversation-cache scratch: finished slots whose KV awaits a
        # batched pool insert this iteration, per-rid page-reservation
        # grants, the per-token prefill-ms EMA feeding cost-aware eviction,
        # and the last-published index counters (delta-inc bookkeeping).
        self._conv_pending: List[Tuple[int, List[int]]] = []
        self._page_reserved: Dict[int, int] = {}
        self._prefill_ms_per_token = 0.0
        self._prefix_published: Dict[str, int] = {}
        self.degraded = False
        self.degraded_reason = ""
        self._thrash_window: Deque[Tuple[int, int]] = deque(maxlen=64)
        self._thrash_last: Tuple[int, int] = (0, 0)

        # Multiplexing: chunked prefill is the production path, so pick a
        # default segment width when none was configured (128: wide enough
        # that a shared-prefix owner drains in a few sub-batches, narrow
        # enough that one segment's compute stays comparable to a burst).
        if self.ecfg.mux and self.ecfg.prefill_chunk <= 0:
            self.ecfg = dc_replace(
                self.ecfg,
                prefill_chunk=max(self.ecfg.min_prefill_bucket, min(128, s)),
            )
        self._align_int4_pages()
        self._init_ragged_geometry()
        self._gate_fused_decode()

        # Prefix cache: host index + device block pool + batched copy ops.
        self._prefix: Optional[PrefixIndex] = None
        if self.ecfg.conv_cache and not self.ecfg.prefix_cache:
            self._fence(
                "conv_cache", False,
                "the conversation cache stores finished streams' KV in "
                "the prefix pool, which prefix_cache=False leaves "
                "uninitialised",
            )
        if self.ecfg.prefix_cache:
            blk = self.ecfg.min_prefill_bucket
            self._prefix_block = blk
            self._prefix_max_blocks = max(1, s // blk)
            # Tail buckets of the cached-wave chunk path; longer tails fall
            # back to plain prefill (the reference's compiled-program set,
            # kept so both engines route the same requests the same way).
            self._chunk_buckets = [
                blk * (2 ** i)
                for i in range(max(1, self.ecfg.prefix_tail_buckets))
                if blk * (2 ** i) <= s
            ]
            self._prefix = PrefixIndex(
                blk, self.ecfg.prefix_pool_blocks, evict=self.ecfg.prefix_evict,
            )
            self._pool = init_pool(self.kv_cache, blk,
                                   self.ecfg.prefix_pool_blocks)
            self._prefix_block_bytes = sum(
                arr.numel() * arr.element_size() for arr in self._pool.values()
            ) // max(1, self.ecfg.prefix_pool_blocks)
            self._publish_prefix_gauges()
            # Row-batched copies: one indexed copy per prefill_rows-wide
            # sub-batch, not per request.
            self._copy_in, self._copy_out = make_batch_copy_ops(
                blk, self._prefix_max_blocks, self.ecfg.prefill_rows,
                packed_keys=pool_packed_keys(self.kv_cache),
            )
            # Page reservation at admission; grants are released when the
            # insert lands or in generate()'s finally (every death path).
            self.scheduler.page_reserve = self._reserve_pages
        global_metrics.set_info("config_fences", list(self.config_fences))

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
        # Prompt-lookup speculation: per-slot proposer history (rid, ids,
        # generated tokens consumed), the per-slot acceptance EMA driving
        # the adaptive burst width, the last-64-burst (proposed, accepted)
        # window behind engine_spec_accept_rate, and the iteration's
        # (proposed, accepted, k) flight scratch.  Both dicts are dropped
        # with their slot or request (_spec_drop): engine_spec_hist_entries
        # is the leak gate.
        self._spec_hist: Dict[int, tuple] = {}
        self._spec_ema: Dict[int, float] = {}
        self._spec_window: Deque[Tuple[int, int]] = deque(maxlen=64)
        self._flight_spec = (0, 0, 0)

        self._requests: Dict[int, _ActiveRequest] = {}
        # Chunked-prefill state: slot -> (run, next segment start), FIFO;
        # each iteration advances up to prefill_rows of these by one
        # prefill_chunk-token segment (_dispatch_segments).
        self._segmented: Dict[int, Tuple[RunningSlot, int]] = {}
        # Multiplexed admission: slot-holding whole-prompt rows awaiting a
        # budgeted wave, the in-flight shared-prefix registry (chain key ->
        # owner rid), per-owner bookkeeping, the parked group waiters, and
        # the rids already counted as dedup hits.
        self._pending_plain: List[RunningSlot] = []
        self._inflight_prefix: Dict[bytes, int] = {}
        self._owner_keys: Dict[int, Tuple[RunningSlot, List[bytes]]] = {}
        self._prefix_waiters: List[Tuple[RunningSlot, int]] = []
        self._dedup_counted: set = set()
        self._mux_ctl: Optional[MuxController] = None
        if self.ecfg.mux:
            self._mux_ctl = MuxController(
                self.ecfg.prefill_chunk or self.ecfg.min_prefill_bucket,
                self.ecfg.prefill_rows,
                self.ecfg.mux_budget_tokens,
            )
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
        # Flight-recorder scratch: per-iteration observations stashed by
        # the methods that own them, read once by the loop's record.
        self._flight_admitted = 0
        self._flight_conv = 0
        self._last_mux: Dict[str, object] = {}
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
        first, lp = self._sample_rows(last_logits, samp, lengths, slots)
        return first, lp, prompt_lps

    def _sample_rows(self, last_logits, samp, pos, slots):
        """First token per prefill row (rows are packed; each reads its
        SLOT's bias plane) and its logprob data when any row asked."""
        first = sampling.sample(last_logits, samp, self._gen, pos=pos,
                                bias=self._bias[slots])
        lp = None
        if (samp.logprobs > 0).any():
            lp = sampling.logprob_data(last_logits, first)
        return first, lp

    def _chunk_prefill_fn(self, tokens, lengths, starts, slots, samp,
                          kv_view: int):
        """Tail-only prefill against reused history KV (prefix-cache tails
        and chunked-prefill segments), cache written IN PLACE; attention
        reads ``cache[:kv_view]``."""
        last_logits, _ = chunk_prefill_into_cache(
            self.mcfg, self.params, tokens, lengths, starts, self.kv_cache,
            slots, kv_view=kv_view,
        )
        return self._sample_rows(last_logits, samp, starts + lengths, slots)

    def _ragged_prefill_fn(self, tokens, descs, sample_idx, samp_pos, slots,
                           samp):
        """Ragged GROUPED tail prefill: the whole group's variable-length
        segments in one ``ragged_prefill_attention`` launch per layer.
        ``sample_idx``/``samp_pos``/``slots`` are per ROW: each row's
        last-real-token logits sample exactly like the chunk path's."""
        last_logits, _ = ragged_prefill_into_cache(
            self.mcfg, self.params, tokens, *descs, sample_idx, self.kv_cache,
            block_q=self._ragged_bq,
        )
        return self._sample_rows(last_logits, samp, samp_pos, slots)

    def _spec_verify_fn(self, tokens, positions, samp, kv_view: int):
        """One speculative step over every row: the carry token and k
        proposals at positions ``[pos .. pos+k]`` (KV written IN PLACE —
        rejected positions hold junk the row's next step rewrites before
        anything attends it), the longest greedy-matching proposal prefix
        accepted, accepted + 1 tokens emitted.  Greedy rows take the
        verifier's argmax at the first mismatch as the bonus token;
        stochastic rows accept nothing and sample position ``pos + 1`` from
        their own (seed, position) stream — a plain decode step.  Returns
        (emitted ``[B, k+1]``, counts ``[B]``)."""
        b, t = tokens.shape
        k = t - 1
        logits, _ = spec_verify_into_cache(
            self.mcfg, self.params, tokens, positions, self.kv_cache,
            kv_view=kv_view,
        )  # [B, t, V]
        if samp.bias_on is not None and samp.bias_on.any():
            logits = logits + self._bias[:, None, :]
        greedy = logits.argmax(dim=-1).to(torch.int32)  # [B, t]
        proposals = tokens[:, 1:]
        match = (greedy[:, :k] == proposals).to(torch.int32)
        greedy_row = torch.as_tensor(samp.temperature <= 0.0, device=self.device)
        n_acc = torch.where(greedy_row, torch.cumprod(match, dim=-1).sum(dim=-1),
                            0)  # [B]
        bonus_greedy = torch.gather(greedy, 1, n_acc[:, None].long())[:, 0]
        # The bias is already folded into the logits.
        sampled0 = sampling.sample(logits[:, 0], samp._replace(bias_on=None),
                                   self._gen, pos=positions + 1)
        bonus = torch.where(greedy_row, bonus_greedy, sampled0)
        idx = torch.arange(t, device=self.device)[None, :]
        prop_pad = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
        emitted = torch.where(
            idx < n_acc[:, None], prop_pad,
            torch.where(idx == n_acc[:, None], bonus[:, None],
                        torch.zeros_like(prop_pad)),
        )
        return emitted, n_acc + 1

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
        burst, one verify burst when speculation is on, and one prefill
        wave before serving, so no request pays for any.  Eager PyTorch
        compiles nothing per shape, so unlike the reference's per-bucket
        program grid (``warmup_plan``) one of each kind suffices."""
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        if self.device.type == "cuda":
            await loop.run_in_executor(self._executor, kernel_build.build)
        await loop.run_in_executor(self._executor, self._warm_decode)
        if self.ecfg.spec_ngram > 0:
            await loop.run_in_executor(self._executor, self._warm_spec)
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

    def _warm_spec(self) -> None:
        """One verify burst at the widest burst with every row parked:
        writes nothing."""
        self._dispatch_spec(view=self._view_buckets()[0],
                            k=self._spec_k_buckets()[-1])

    def warmup_plan(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """The reference's program grid as ``(kind, bucket shape)`` pairs:
        ``decode (view, steps)``, ``spec (view, k)`` over the adaptive
        burst-width ladder, ``prefill (width,)``, and ``ragged (tot,)`` or
        the ``chunk (tail, view)`` family — the shapes a serving dispatch
        can reach.  The port compiles nothing per shape (``warmup`` runs
        one program of each kind); the plan states what serving reaches."""
        views = self._view_buckets()
        steps = {self.ecfg.decode_steps}
        if 0 < self.ecfg.decode_steps_eager < self.ecfg.decode_steps:
            steps.add(self.ecfg.decode_steps_eager)
        plan: List[Tuple[str, Tuple[int, ...]]] = [
            ("decode", (v, k)) for v in views for k in sorted(steps)]
        if self.ecfg.spec_ngram > 0:
            plan += [("spec", (v, k))
                     for v in views for k in self._spec_k_buckets()]
        plan.append(("prefill", (self._bucket(1),)))
        if self.ecfg.ragged_prefill:
            plan.append(("ragged", (self._ragged_tot,)))
            return plan
        chunk_pairs = set()
        if self._prefix is not None:
            chunk_pairs |= {(t, v) for t in self._chunk_buckets
                            for v in views if v >= t}
        if self.ecfg.prefill_chunk > 0:
            chunk_pairs |= {(self.ecfg.prefill_chunk, v) for v in views
                            if v >= self.ecfg.prefill_chunk}
        return plan + [("chunk", pair) for pair in sorted(chunk_pairs)]

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
            "segmented_slots": sorted(self._segmented),
            "pending_plain": len(self._pending_plain),
            "prefix_waiters": len(self._prefix_waiters),
            "inflight_prefix_keys": len(self._inflight_prefix),
            "config_fences": list(self.config_fences),
            "prefix_pool": None if self._prefix is None else {
                "pages_used": self._prefix.used_blocks,
                "pages_free": self._prefix.free_blocks,
                "pages_reserved": self._prefix.reserved_pages,
                "evictions": self._prefix.evictions,
                "conv_pending": len(self._conv_pending),
                "thrash_reallocs": self._prefix.thrash_reallocs,
            },
            "degraded": self.degraded,
            "degraded_reason": self.degraded_reason,
            "crashed": self._crashed,
            "warmup_done": self._warmup_done,
        }

    # -- admission surface ---------------------------------------------------

    def admission_check(self, n: int = 1, tenant: str = "") -> Optional[str]:
        """Pre-flight admission verdict: None (admit), ``"busy"`` or
        ``"tenant_overlimit"`` — the reference's queue arithmetic (this
        port has no spill tier, so never ``"memory"``)."""
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
            # Speculation state must not outlive its request: this is the
            # one exit path that sees consumer cancels.
            self._spec_drop_rid(rid)
            # Page-reservation release on EVERY exit path (finish, deadline,
            # cancel, shed, crash): the leak-gate contract.  Idempotent.
            self._release_pages(rid)
            global_metrics.tenant_end(tenant)
            if state.first_token_at is None and state.finish:
                # Ended server-side without a first token: a bad TTFT event.
                global_slo.record("ttft", False)
            if state.trace is not None:
                t_end = time.monotonic()
                if state.t_parked is not None:
                    # Still parked behind a prefix owner at exit: close the
                    # park span here.
                    global_tracer.add_span(
                        "engine.prefix_park",
                        trace_id=state.trace.trace_id,
                        parent_id=state.trace_span, track="engine",
                        t0=state.t_parked, t1=t_end,
                        attrs={"terminated": state.finish or "cancelled"},
                    )
                    state.t_parked = None
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
                                hists: Optional[List[int]] = None,
                                echo: bool = False) -> _HostCopy:
        """Dispatch one wave of admitted prompts (bucket width ``t``) and
        start the copy of its first tokens to the host WITHOUT waiting for
        it; rows are padded to ``prefill_rows``, pad rows write the
        scratch slot.

        With ``hists`` (prefix-cache path) row i's first ``hists[i]``
        tokens are already in the cache (copied from the pool before this
        dispatch, same executor, same stream order) and only the tail is
        computed through the chunk path; ``t`` then buckets the TAIL."""
        if hists is not None:
            rows = [
                (run, hist, run.request.prompt_ids[hist:], True)
                for run, hist in zip(runs, hists)
            ]
            return self._dispatch_chunk_rows(rows, t)
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

    def _row_controls(self, rows, nb: int):
        """Sampling controls for packed rows of ``(run, start, seg,
        sample?)``: non-sampled rows (mid-prompt segments) get zeroed
        controls and their returned token is discarded.  Penalties are zero:
        the FIRST token has no generated predecessors."""
        temp = np.zeros((nb,), np.float32)
        top_k = np.zeros((nb,), np.int32)
        top_p = np.ones((nb,), np.float32)
        lps = np.zeros((nb,), np.int32)
        seeds = np.zeros((nb,), np.uint32)
        bias_on = np.zeros((nb,), bool)
        for i, (run, _start, _seg, sample) in enumerate(rows):
            if sample:
                temp[i] = run.request.temperature
                top_k[i] = run.request.top_k
                top_p[i] = run.request.top_p
                lps[i] = run.request.logprobs
                seeds[i] = run.request.seed
                bias_on[i] = bool(run.request.logit_bias)
        self._apply_logit_bias([run for (run, _s, _g, sample) in rows if sample])
        zeros = np.zeros((nb,), np.float32)
        return sampling.SamplingParams(temp, top_k, top_p, zeros, zeros, lps,
                                       seeds, bias_on)

    @torch.inference_mode()
    def _dispatch_chunk_rows(self, rows, t: int) -> _HostCopy:
        """Pack rows of ``(run, start, segment_ids, sample?)`` into ONE
        chunk-prefill dispatch at tail width ``t`` (executor thread) — the
        single home of the padding/scratch-slot/sampling-row packing shared
        by prefix-cache tails and chunked-prefill segments.

        With ``ragged_prefill`` the SAME rows go to the ragged grouped
        launch instead: every chunk consumer (mux segments, prefix tails,
        the non-mux cached wave) shares it without changing its routing."""
        if self.ecfg.ragged_prefill:
            return self._dispatch_ragged_rows(rows)
        nb = max(self.ecfg.prefill_rows, len(rows))
        tokens = np.zeros((nb, t), np.int32)
        lengths = np.ones((nb,), np.int32)
        starts = np.zeros((nb,), np.int32)
        slots = np.full((nb,), self._scratch_slot, np.int64)
        total = 0
        for i, (run, start, seg, _sample) in enumerate(rows):
            tokens[i, : len(seg)] = seg
            lengths[i] = len(seg)
            starts[i] = start
            slots[i] = run.slot
            total += len(seg)
        samp = self._row_controls(rows, nb)
        # Smallest view covering every row's history + padded tail.
        view = self._chunk_view_bucket(int(starts.max()) + t)
        first, lp = self._chunk_prefill_fn(
            self._host(tokens), self._host(lengths), self._host(starts),
            self._host(slots), samp, view,
        )
        global_metrics.inc("engine_prefill_tokens_total", total)
        return _HostCopy((first, lp, None))

    @torch.inference_mode()
    def _dispatch_ragged_rows(self, rows) -> _HostCopy:
        """Ragged grouped launch (executor thread): pack rows of ``(run,
        start, segment_ids, sample?)`` into the flat-token bucket and
        dispatch ONE grouped program — the ragged twin of
        :meth:`_dispatch_chunk_rows` with identical row-order outputs, so
        every consumer is oblivious to which path ran."""
        bq = self._ragged_bq
        entries = [(run.slot, start, len(seg)) for run, start, seg, _s in rows]
        tot = self._ragged_tot
        need = sum(-(-ln // bq) * bq for _sl, _st, ln in entries)
        if need > tot:
            # Defensive only: dispatch sites cap rows at prefill_rows and
            # per-row tails at the arithmetic _ragged_tot was sized from.
            tot = -(-need // bq) * bq
        slot_of, start_of, qoff_of, _qlen_of, base_of, offs = plan_ragged_group(
            entries, bq, tot, self._scratch_slot,
            max_row_blocks=self._ragged_row_blocks,
        )
        tokens = np.zeros((tot,), np.int32)
        nb = max(self.ecfg.prefill_rows, len(rows))
        sample_idx = np.zeros((nb,), np.int64)
        samp_pos = np.zeros((nb,), np.int32)
        slots = np.full((nb,), self._scratch_slot, np.int64)
        total = 0
        for i, ((run, start, seg, _sample), off) in enumerate(zip(rows, offs)):
            tokens[off : off + len(seg)] = seg
            sample_idx[i] = off + len(seg) - 1
            samp_pos[i] = start + len(seg)
            slots[i] = run.slot
            total += len(seg)
        samp = self._row_controls(rows, nb)
        first, lp = self._ragged_prefill_fn(
            self._host(tokens),
            [self._host(x) for x in (slot_of, start_of, qoff_of, base_of)],
            self._host(sample_idx), self._host(samp_pos), self._host(slots),
            samp,
        )
        global_metrics.inc("engine_prefill_tokens_total", total)
        return _HostCopy((first, lp, None))

    def _chunk_view_bucket(self, need: int) -> int:
        """Smallest kv-view bucket covering ``need`` cache positions — the
        decode bucket set (_view_buckets)."""
        for view in self._view_buckets():
            if view >= need:
                return view
        return self.ecfg.max_seq

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
        (the device carry can run up to two bursts ahead of the host) and,
        with speculation, by the widest verify burst: its proposals' KV at
        ``pos + K`` must be attendable, and the adaptive K can grow
        mid-bucket."""
        n = self.ecfg.num_slots
        active = self._active_mask[:n]
        need = 1
        if active.any():
            need = int(self._positions[:n][active].max()) + 1
        need += 2 * self.ecfg.decode_steps + 1
        if self.ecfg.spec_ngram > 0:
            need += self._spec_k_cap()
        for view in self._view_buckets():
            if view >= need:
                return view
        return self.ecfg.max_seq

    def _burst_steps(self) -> int:
        """Full burst normally; the eager burst while work waits AND an
        admission could land soon (a free slot, or one finishing within a
        full burst).  Under mux a non-empty prefill backlog (segments,
        pending whole-prompt rows, parked group waiters) also selects the
        eager burst: backlogged rows advance once per loop iteration, so
        the burst length IS their wait."""
        eager = self.ecfg.decode_steps_eager
        if not (eager and 0 < eager < self.ecfg.decode_steps):
            return self.ecfg.decode_steps
        if self.ecfg.mux and (self._segmented or self._pending_plain
                              or self._prefix_waiters):
            return eager
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

    # -- speculative decoding ----------------------------------------------

    #: Proposer search window: the backward n-gram scan is bounded so the
    #: per-step host cost stays O(window), not O(context).
    SPEC_SEARCH_WINDOW = 1024
    #: Acceptance-EMA blend: a new burst weighs 0.2 (~5-burst memory).
    SPEC_EMA_ALPHA = 0.2

    def _spec_k_cap(self) -> int:
        """Widest verify burst any dispatch can reach: spec_k, or
        spec_k_max when the adaptive ladder is enabled above it."""
        return max(self.ecfg.spec_k, self.ecfg.spec_k_max)

    def _spec_adaptive(self) -> bool:
        return self.ecfg.spec_k_max > self.ecfg.spec_k

    def _spec_k_buckets(self) -> List[int]:
        """Burst widths K a spec dispatch may select: exactly {spec_k} when
        fixed; adaptive, the powers of two below spec_k_max plus the cap,
        so the EMA can shrink a cold slot to K=1 and grow a hot one to the
        cap."""
        if not self._spec_adaptive():
            return [self.ecfg.spec_k]
        mx = self.ecfg.spec_k_max
        ks = {mx}
        k = 1
        while k < mx:
            ks.add(k)
            k *= 2
        return sorted(ks)

    def _spec_pick_k(self) -> int:
        """This dispatch's burst width: the smallest bucket covering every
        active greedy slot's desired width (acceptance EMA x cap).  The
        batch takes the max over slots — verify is one program over all
        rows, so the narrowest slot just wastes a few verify columns while
        its EMA converges."""
        buckets = self._spec_k_buckets()
        if not self._spec_adaptive():
            return buckets[-1]
        mx = self.ecfg.spec_k_max
        init = self.ecfg.spec_k / mx
        want = 1
        n = self.ecfg.num_slots
        for i in np.nonzero(self._active_mask[:n])[0]:
            if self._temp[i] <= 0.0:
                ema = self._spec_ema.get(int(i), init)
                want = max(want, int(round(ema * mx)))
        want = min(max(1, want), mx)
        return next(b for b in buckets if b >= want)

    def _spec_drop(self, slot: int) -> None:
        """Release a slot's proposer history and acceptance EMA (eviction,
        deadline, cancel): the registry never outlives its request."""
        self._spec_hist.pop(slot, None)
        self._spec_ema.pop(slot, None)
        global_metrics.set_gauge("engine_spec_hist_entries", len(self._spec_hist))

    def _spec_drop_rid(self, rid: int) -> None:
        """Drop spec state for a request wherever it sits (the cancel path
        knows the rid, not the slot)."""
        for i, entry in list(self._spec_hist.items()):
            if entry[0] == rid:
                self._spec_drop(i)

    def _propose(self, run: RunningSlot, k: int) -> np.ndarray:
        """Prompt-lookup proposal: the continuation of the most recent
        PRIOR occurrence of the last spec_ngram tokens in this request's
        prompt + generation history (bounded backward search).  A bad
        proposal is harmless — the verifier accepts only tokens greedy
        decoding would produce — so a row without a match proposes zeros.
        The history is cached per slot and extended incrementally."""
        out = np.zeros((k,), np.int32)
        n = self.ecfg.spec_ngram
        i = run.slot
        cached = self._spec_hist.get(i)
        if cached is None or cached[0] != run.request.request_id:
            # Slot reused by a new request: its predecessor's acceptance
            # memory must not steer the newcomer's burst width.
            self._spec_ema.pop(i, None)
            cached = (run.request.request_id,
                      [int(t) for t in run.request.prompt_ids], 0)
            self._spec_hist[i] = cached
            global_metrics.set_gauge("engine_spec_hist_entries",
                                     len(self._spec_hist))
        rid, hist, consumed = cached
        gen = run.generated
        if consumed < len(gen):
            hist.extend(int(t) for t in gen[consumed:])
            self._spec_hist[i] = (rid, hist, len(gen))
        if len(hist) <= n:
            return out
        tail = hist[-n:]
        lo = max(0, len(hist) - n - self.SPEC_SEARCH_WINDOW)
        for st in range(len(hist) - n - 1, lo - 1, -1):
            if hist[st : st + n] == tail:
                cont = hist[st + n : st + n + k]
                out[: len(cont)] = cont
                break
        return out

    def _spec_usable(self) -> bool:
        """Speculation covers rows whose features it supports: any active
        row needing penalties or logprobs sends the whole batch down the
        plain path, and so does a batch with no greedy row (nothing could
        be accepted, and a synchronous step per token would lose to the
        pipelined burst)."""
        if self.ecfg.spec_ngram <= 0:
            return False
        a = self._active_mask
        if not bool(np.any(a & (self._temp <= 0.0))):
            return False
        return not bool(np.any(
            a & ((self._freq_pen != 0.0) | (self._pres_pen != 0.0)
                 | (self._logprobs > 0))
        ))

    @torch.inference_mode()
    def _dispatch_spec(self, *, view: Optional[int] = None,
                       k: Optional[int] = None):
        """(executor thread) One speculative verify step over every row;
        returns ((emitted [R, k+1], counts [R]), request-id snapshot).
        ``k`` is the burst width (adaptive mode picks it from the bucket
        ladder).  Host-carried state, no pipelining: the host reads the
        per-row counts before it can feed consumers anyway.  The device
        decode carry goes stale, so the next plain burst gets a full
        override patch."""
        rows = self.ecfg.num_slots + 1
        if k is None:
            k = self._spec_pick_k()
        tokens = np.zeros((rows, 1 + k), np.int32)
        tokens[:, 0] = self._last_token
        for i in np.nonzero(self._active_mask)[0]:
            run = self.scheduler.slots[i] if i < self.ecfg.num_slots else None
            if run is not None:
                tokens[i, 1:] = self._propose(run, k)
        active = self._active_mask
        # Inactive rows park at max_seq: the verify burst writes nothing
        # for them.
        positions = np.where(active, self._positions, self.ecfg.max_seq)
        samp = sampling.SamplingParams(
            temperature=self._temp.copy(),
            top_k=self._top_k.copy(),
            top_p=self._top_p.copy(),
            freq_pen=np.zeros((rows,), np.float32),
            pres_pen=np.zeros((rows,), np.float32),
            logprobs=np.zeros((rows,), np.int32),
            seed=self._sample_seed.copy(),
            bias_on=self._slot_bias_on & active,
        )
        view = self._kv_view_bucket() if view is None else view
        emitted, counts = self._spec_verify_fn(
            self._host(tokens), self._host(positions.astype(np.int32)), samp,
            view,
        )
        assign = [
            run.request.request_id
            if run is not None and self._active_mask[i] else None
            for i, run in enumerate(self.scheduler.slots)
        ] + [None]
        out = _HostCopy((emitted, counts)).get()
        # The device decode carry is stale for every row now.
        self._ov_mask[:] = True
        return out, assign

    async def _process_spec(self, outs, assign: List) -> None:
        """Account one verify burst: each live row's accepted tokens and
        its bonus token, cut short at a stop or limit; acceptance
        bookkeeping (EMA, window, counters) over greedy rows only —
        stochastic rows accept nothing by construction."""
        emitted, counts = outs
        k = emitted.shape[1] - 1  # this burst's width
        n_emitted = n_rows = proposed = accepted = 0
        for i in np.nonzero(self._active_mask)[0]:
            run = self.scheduler.slots[i] if i < self.ecfg.num_slots else None
            if run is None:
                self._active_mask[i] = False
                self._spec_drop(int(i))
                continue
            if run.request.request_id != assign[i]:
                continue
            n_rows += 1
            if self._temp[i] <= 0.0 and k > 0:
                acc = int(counts[i]) - 1
                proposed += k
                accepted += acc
                prev = self._spec_ema.get(
                    int(i), self.ecfg.spec_k / max(1, self._spec_k_cap()))
                self._spec_ema[int(i)] = (
                    (1.0 - self.SPEC_EMA_ALPHA) * prev
                    + self.SPEC_EMA_ALPHA * (acc / k)
                )
            for j in range(int(counts[i])):
                n_emitted += 1
                self._account_token(int(i), int(emitted[i, j]))
                if not self._active_mask[i]:
                    break  # stop or limit mid-acceptance: surplus dropped
            await asyncio.sleep(0)
        if n_rows:
            global_metrics.inc("engine_spec_tokens_total", n_emitted)
            global_metrics.inc("engine_spec_accepted_tokens_total",
                               n_emitted - n_rows)
            global_metrics.inc("engine_spec_proposed_tokens_total", proposed)
            self._spec_window.append((proposed, accepted))
            w_prop = sum(p for p, _ in self._spec_window)
            w_acc = sum(a for _, a in self._spec_window)
            global_metrics.set_gauge("engine_spec_accept_rate",
                                     (w_acc / w_prop) if w_prop else 0.0)
            self._flight_spec = (proposed, accepted, k)

    def _expire_deadlines(self) -> None:
        """Evict deadline-blown requests (queue or slot) and fail their
        consumers with DeadlineExceeded; once per loop iteration."""
        expired = self.scheduler.expire(time.monotonic())
        for slot, req in expired:
            if slot is not None:
                self._active_mask[slot] = False
                self._spec_drop(slot)
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
            self._spec_drop(slot)
            if self._prefix is not None and self.ecfg.conv_cache:
                # Every record_token eviction is a NATURAL finish.  The
                # finished stream's KV covers positions [0, cache_len-1)
                # (the final token was never fed back); queue its full-page
                # prefix for the end-of-iteration batched insert, so a
                # next turn that resends the conversation matches through.
                seq = out.request.prompt_ids + out.generated[:-1]
                if len(seq) >= self._prefix_block:
                    self._conv_pending.append((slot, seq))
        else:
            self._last_token[slot] = tok
            # The generated token's own position: the decode step that
            # consumes it writes it to the cache.
            self._positions[slot] = out.cache_len - 1
        self._emit(out, tok, evicted, lp_info, prompt_lps)

    def _prefix_copy_in(self, hits: List[Tuple[int, List[int]]]) -> None:
        """Copy matched pool blocks into the hit slots (executor thread):
        ``hits`` is [(slot, pool_ids)], ONE batched copy per
        prefill_rows-wide sub-batch."""
        pr = self.ecfg.prefill_rows
        for lo in range(0, len(hits), pr):
            entries = [
                (slot, ids, list(range(len(ids))))
                for slot, ids in hits[lo : lo + pr]
            ]
            slots, pids, bnos = pad_rows(
                entries, pr, self._prefix_max_blocks, scratch=None
            )
            with torch.inference_mode():
                self._copy_in(self.kv_cache, self._pool, slots, pids, bnos)

    def _prefix_insert(self, runs: List[RunningSlot]) -> None:
        """Save the runs' now-prefilled, not-yet-pooled prompt blocks into
        the pool (executor thread), one batched copy per prefill_rows;
        same-wave eviction hazards are planned out by ``plan_inserts``."""
        entries = plan_inserts(
            self._prefix,
            [(run.slot, run.request.prompt_ids) for run in runs],
            ms_per_token=self._prefill_ms_per_token or 1.0,
        )
        total = sum(len(ids) for _, ids, _ in entries)
        self._copy_out_entries(entries)
        if total:
            global_metrics.inc("engine_prefix_saved_blocks_total", total)

    def _copy_out_entries(self, entries) -> None:
        pr = self.ecfg.prefill_rows
        for lo in range(0, len(entries), pr):
            slots, pids, bnos = pad_rows(
                entries[lo : lo + pr], pr, self._prefix_max_blocks, scratch=0,
            )
            with torch.inference_mode():
                self._copy_out(self._pool, self.kv_cache, slots, pids, bnos)

    async def _admit_pending(self, loop) -> None:
        """Non-mux admission: admit what the scheduler allows and prefill
        it (see _dispatch_plain_waves)."""
        admitted = self.scheduler.admit()
        if not admitted:
            return
        self._note_admission(admitted)
        await self._dispatch_plain_waves(loop, admitted)

    def _note_admission(self, admitted: List[RunningSlot]) -> None:
        """Stamp slot-admission time and record the queue-wait half of the
        TTFT decomposition."""
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

    async def _dispatch_plain_waves(
        self, loop, admitted: List[RunningSlot]
    ) -> None:
        """Dispatch one admission wave's prefills.  Every wave is
        DISPATCHED first, then fetched in dispatch order, so wave n+1
        computes while wave n's first tokens travel to the host.

        With the prefix cache each prompt is first matched against the
        pool: matched runs get their history copied into their slot
        (dispatched before their prefill, same executor, same stream
        order) and are grouped by TAIL bucket.  Long tails go to the
        chunked-prefill queue instead.  After a run's prefill lands its
        uncached full blocks are saved back to the pool, off the
        TTFT-critical path.  Callers: the non-mux admission path (whole
        wave), the mux echo route, and the mux budgeted whole-prompt
        drain."""
        hist_of: Dict[int, int] = {}
        pool_ids_of: Dict[int, List[int]] = {}
        for run in admitted:
            hist = 0
            # Echo/scoring requests need logits for EVERY prompt position:
            # they always take the whole-prompt plain path.
            if self._prefix is not None and not run.request.echo_logprobs:
                hist, ids = self._prefix.match(run.request.prompt_ids)
                if hist:
                    pool_ids_of[run.slot] = ids
            hist_of[run.slot] = hist
        if self.ecfg.prefill_chunk > 0:
            # Long tails advance one segment per loop iteration; their
            # prefix copy-in dispatches NOW, ahead of every segment.
            seg_hits: List[Tuple[int, List[int]]] = []
            for run in list(admitted):
                if run.request.echo_logprobs:
                    continue
                hist = hist_of[run.slot]
                if len(run.request.prompt_ids) - hist > self.ecfg.prefill_chunk:
                    if hist:
                        seg_hits.append((run.slot, pool_ids_of[run.slot]))
                        global_metrics.inc(
                            "engine_prefix_hit_tokens_total", hist
                        )
                    self._segmented[run.slot] = (run, hist)
                    admitted.remove(run)
            if seg_hits:
                await loop.run_in_executor(
                    self._executor, self._prefix_copy_in, seg_hits
                )
        # Group by (tail bucket, cached?, echo): a matched prefix whose tail
        # exceeds every chunk bucket drops back to the plain path, as in
        # the reference.
        groups: Dict[Tuple[int, bool, bool], List[RunningSlot]] = {}
        for run in admitted:
            hist = hist_of[run.slot]
            if hist and (
                len(run.request.prompt_ids) - hist > self._chunk_buckets[-1]
            ):
                hist = hist_of[run.slot] = 0
            if hist:
                global_metrics.inc("engine_prefix_hit_tokens_total", hist)
            t = self._bucket(len(run.request.prompt_ids) - hist)
            echo = bool(run.request.echo_logprobs)
            groups.setdefault((t, hist > 0, echo), []).append(run)
        pr = self.ecfg.prefill_rows
        dispatched = []
        for (t, cached, echo), runs in sorted(groups.items()):
            for i in range(0, len(runs), pr):
                wave = runs[i : i + pr]
                t0 = time.monotonic()
                if cached:
                    await loop.run_in_executor(
                        self._executor, self._prefix_copy_in,
                        [(run.slot, pool_ids_of[run.slot]) for run in wave],
                    )
                hists = [hist_of[r.slot] for r in wave] if cached else None
                pending = await loop.run_in_executor(
                    self._executor, self._dispatch_prefill_batch, wave, t,
                    hists, echo,
                )
                dispatched.append((wave, pending, t0))
        inserts: List[RunningSlot] = []
        for runs, pending, t0 in dispatched:
            firsts, lp, plp = await loop.run_in_executor(
                self._executor, pending.get
            )
            wall_ms = (time.monotonic() - t0) * 1000.0
            global_metrics.observe("engine_prefill_ms", wall_ms)
            self._note_prefill_cost(
                sum(len(r.request.prompt_ids) - hist_of.get(r.slot, 0)
                    for r in runs),
                wall_ms,
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
                if self._prefix is not None:
                    inserts.append(run)
        # Pool inserts run after EVERY first token of the wave is out.
        live = [r for r in inserts if self.scheduler.slots[r.slot] is r]
        if live:
            await loop.run_in_executor(
                self._executor, self._prefix_insert, live
            )
            self._release_pages_for(live)

    # -- multiplexed admission ---------------------------------------------

    async def _admit_mux(self, loop) -> None:
        """Multiplexed admission: bind waiting requests to slots (FIFO) and
        ROUTE them — echo/scoring requests to the whole-prompt wave,
        everything else into the prefill backlog — WITHOUT dispatching
        prefill work here; the backlog drains under the iteration token
        budget in the main loop, interleaved with decode bursts.  With the
        prefix cache the wave is grouped by PrefixIndex block keys first:
        a shared not-yet-pooled prefix is computed by its FIFO-first
        requester only, later members park (_mux_wake)."""
        admitted = self.scheduler.admit()
        if not admitted:
            return
        self._note_admission(admitted)
        echo = [r for r in admitted if r.request.echo_logprobs]
        if echo:
            await self._dispatch_plain_waves(loop, echo)
        rest = [r for r in admitted if not r.request.echo_logprobs]
        if not rest:
            return
        if self._prefix is None:
            if self.ecfg.prefill_chunk > 0:
                for run in rest:
                    self._segmented[run.slot] = (run, 0)
            else:
                self._pending_plain.extend(rest)
            return
        await self._plan_mux_wave(loop, rest)

    async def _plan_mux_wave(self, loop, runs: List[RunningSlot]) -> None:
        """Group ``runs`` (FIFO order) against the pool and the in-flight
        prefix registry; enqueue the owners, park the waiters.  Shared by
        fresh admissions and waiter re-planning (_mux_wake), so a woken
        waiter can itself become the owner of its remaining blocks."""
        by_rid = {run.request.request_id: run for run in runs}
        owners, waiters = plan_group_admission(
            self._prefix, self._inflight_prefix,
            [(run.request.request_id, run.request.prompt_ids) for run in runs],
        )
        for rid, owner_rid in waiters:
            self._prefix_waiters.append((by_rid[rid], owner_rid))
            state = self._requests.get(rid)
            if (state is not None and state.trace is not None
                    and state.t_parked is None):
                state.t_parked = time.monotonic()
            if rid not in self._dedup_counted:
                self._dedup_counted.add(rid)
                global_metrics.inc("engine_prefix_dedup_hits_total")
        hits: List[Tuple[int, List[int]]] = []
        for rid, hist, pool_ids, keys in owners:
            run = by_rid[rid]
            self._dedup_counted.discard(rid)
            state = self._requests.get(rid)
            if state is not None and state.trace is not None:
                if state.t_parked is not None:
                    global_tracer.add_span(
                        "engine.prefix_park",
                        trace_id=state.trace.trace_id,
                        parent_id=state.trace_span, track="engine",
                        t0=state.t_parked,
                        attrs={"promoted_owner": bool(keys)},
                    )
                    state.t_parked = None
                if keys:
                    global_tracer.add_event(
                        "engine.prefix_own",
                        trace_id=state.trace.trace_id,
                        parent_id=state.trace_span, track="engine",
                        attrs={"keys": len(keys), "hist_tokens": hist},
                    )
            if keys:
                self._owner_keys[rid] = (run, keys)
            if hist:
                hits.append((run.slot, pool_ids))
                global_metrics.inc("engine_prefix_hit_tokens_total", hist)
            self._segmented[run.slot] = (run, hist)
        if hits:
            # Before any of the wave's segments (same executor, same
            # stream order): reused history is in place for the first one.
            await loop.run_in_executor(
                self._executor, self._prefix_copy_in, hits
            )

    async def _mux_wake(self, loop) -> None:
        """Release dead owners' in-flight prefix claims and RE-PLAN waiters
        whose owner finished (its blocks are pooled — _finish_segments
        inserts before this runs) or died mid-prefill (the first waiter is
        promoted to owner).  Once per loop iteration."""
        for rid, (run, _keys) in list(self._owner_keys.items()):
            seg = self._segmented.get(run.slot)
            alive = (self.scheduler.slots[run.slot] is run
                     and seg is not None and seg[0] is run)
            if not alive:
                self._owner_done(rid)
        if not self._prefix_waiters:
            return
        ready: List[RunningSlot] = []
        still: List[Tuple[RunningSlot, int]] = []
        for run, owner_rid in self._prefix_waiters:
            if self.scheduler.slots[run.slot] is not run:
                # Cancelled/expired while parked; slot reclaimed.
                self._dedup_counted.discard(run.request.request_id)
                continue
            if owner_rid in self._owner_keys:
                still.append((run, owner_rid))
            else:
                ready.append(run)
        self._prefix_waiters = still
        if ready:
            await self._plan_mux_wave(loop, ready)

    def _owner_done(self, rid: int) -> None:
        """Drop a finished/dead owner's claims from the in-flight prefix
        registry so its waiters re-plan at the next _mux_wake."""
        entry = self._owner_keys.pop(rid, None)
        if entry is None:
            return
        for key in entry[1]:
            if self._inflight_prefix.get(key) == rid:
                del self._inflight_prefix[key]

    def _mux_budget(self) -> int:
        """This iteration's prefill budget in SEGMENT ROWS, from the
        controller's token budget (published as engine_mux_budget_tokens).
        The backlog counts remaining DISPATCH rows — a half-done long
        prompt contributes its remaining segment count."""
        chunk = max(1, self._mux_ctl.unit)
        backlog = len(self._pending_plain)
        for run, start in self._segmented.values():
            rest = len(run.request.prompt_ids) - start
            backlog += max(1, -(-rest // chunk))
        n = self.ecfg.num_slots
        active = int(np.count_nonzero(self._active_mask[:n]))
        now = time.monotonic()
        # Every place a not-yet-decoding request can sit: a tight deadline
        # in ANY of them triggers the controller's rescue drain.
        slacks = [req.deadline - now for req in self.scheduler.waiting
                  if req.deadline is not None]
        slacks += [run.request.deadline - now
                   for run, _start in self._segmented.values()
                   if run.request.deadline is not None]
        slacks += [run.request.deadline - now for run in self._pending_plain
                   if run.request.deadline is not None]
        slacks += [run.request.deadline - now
                   for run, _owner in self._prefix_waiters
                   if run.request.deadline is not None]
        min_slack = min(slacks) if slacks else None
        # A verify burst moves up to K + 1 tokens per slot in one pass: the
        # controller's decode-stall bound charges it as such.
        drt = 1
        if self._spec_usable() and any(self._active_mask):
            drt = 1 + self._spec_pick_k()
        tokens = self._mux_ctl.budget_tokens(
            queue_depth=self.scheduler.queue_depth,
            backlog_rows=backlog,
            active_rows=active,
            min_slack_s=min_slack,
            decode_row_tokens=drt,
        )
        global_metrics.set_gauge("engine_mux_budget_tokens", tokens)
        self._last_mux = {
            "backlog_rows": backlog,
            "min_slack_s": (round(min_slack, 3)
                            if min_slack is not None else None),
            "budget_tokens": tokens,
        }
        return tokens // self._mux_ctl.unit

    def _dispatch_segments(self, max_rows: Optional[int] = None):
        """Advance up to ``prefill_rows`` chunked-prefill slots (or the
        iteration's ``max_rows`` budget under mux, whichever is smaller)
        by ONE segment each, as one chunk dispatch (executor thread).

        Returns (rows, pending, t_dispatch, n_tokens) — rows is
        [(run, was_final)] in row order, n_tokens counts REAL segment
        tokens — or None when nothing is pending.  A final (short)
        segment's pad positions write junk KV past the prompt end, which
        decode overwrites before it ever becomes attendable."""
        limit = self.ecfg.prefill_rows
        if max_rows is not None:
            limit = min(limit, max_rows)
        if not self._segmented or limit <= 0:
            return None
        chunk = self.ecfg.prefill_chunk
        picked: List[Tuple[RunningSlot, int]] = []
        for slot in list(self._segmented):
            run, start = self._segmented[slot]
            if self.scheduler.slots[slot] is not run:  # cancelled
                del self._segmented[slot]
                continue
            picked.append((run, start))
            if len(picked) == limit:
                break
        if not picked:
            return None
        chunk_rows = []
        rows: List[Tuple[RunningSlot, bool]] = []
        n_tokens = 0
        for run, start in picked:
            ids = run.request.prompt_ids
            seg = ids[start : start + chunk]
            final = start + len(seg) >= len(ids)
            if final:
                del self._segmented[run.slot]
            else:
                self._segmented[run.slot] = (run, start + len(seg))
            chunk_rows.append((run, start, seg, final))
            rows.append((run, final))
            n_tokens += len(seg)
        t_dispatch = time.monotonic()
        pending = self._dispatch_chunk_rows(chunk_rows, chunk)
        global_metrics.inc("engine_prefill_segments_total", len(rows))
        return rows, pending, t_dispatch, n_tokens

    async def _finish_segments(self, loop, seg) -> None:
        """Fetch a segment dispatch's sampled block (pinned copy + CUDA
        event, never a blocking ``.cpu()``); activate final rows."""
        rows, pending, t_dispatch, n_tokens = seg
        firsts, lp, _plp = await loop.run_in_executor(
            self._executor, pending.get
        )
        # REAL segment tokens: pad positions would underprice every page
        # for cost-aware eviction.
        self._note_prefill_cost(
            n_tokens, (time.monotonic() - t_dispatch) * 1000.0,
        )
        if global_tracer.enabled:
            global_tracer.add_span(
                "engine.prefill_segment", trace_id=None, track="engine-loop",
                t0=t_dispatch,
                attrs={"rows": len(rows),
                       "final": sum(1 for _r, f in rows if f)},
            )
        inserts: List[RunningSlot] = []
        for i, (run, final) in enumerate(rows):
            if not final or self.scheduler.slots[run.slot] is not run:
                continue
            self._admit_one(run)
            lp_row = None if lp is None else (lp[0][i], lp[1][i], lp[2][i])
            self._account_token(run.slot, int(firsts[i]), lp_row)
            if self._prefix is not None:
                inserts.append(run)
        if inserts:
            await loop.run_in_executor(
                self._executor, self._prefix_insert, inserts
            )
            self._release_pages_for(inserts)

    def _init_ragged_geometry(self) -> None:
        """Ragged grouped prefill geometry and the gates that apply on the
        card.  The q-block width must divide every chunk start (page and
        segment multiples), so it is the largest power-of-two divisor of
        both units, capped at 128; the flat bucket holds prefill_rows rows
        of the widest per-row tail (a mux segment or the largest prefix
        tail bucket)."""
        self._ragged_bq = 0
        self._ragged_tot = 0
        self._ragged_row_blocks = 0
        if not self.ecfg.ragged_prefill:
            return
        from p2p_llm_tunnel_tpu_torch.ops.prefill_attention import _SUPPORTED_D

        unit = self.ecfg.prefill_chunk or self.ecfg.min_prefill_bucket
        div = math.gcd(self.ecfg.min_prefill_bucket, unit)
        bq = next((c for c in (128, 64, 32, 16, 8) if div % c == 0), 0)
        if bq == 0:
            self._fence(
                "ragged_prefill", False,
                f"no power-of-2 q-block width >= 8 divides both "
                f"min_prefill_bucket={self.ecfg.min_prefill_bucket} and "
                f"prefill_chunk={unit} — chunk starts would misalign the "
                f"grouped cache-append blocks",
            )
        elif self.ecfg.max_seq % bq:
            self._fence(
                "ragged_prefill", False,
                f"max_seq {self.ecfg.max_seq} is not a multiple of the "
                f"q-block width {bq}: the last append block would overrun "
                f"the cache",
            )
        elif (self.device.type == "cuda"
              and self.mcfg.head_dim not in _SUPPORTED_D):
            self._fence(
                "ragged_prefill", False,
                f"head_dim {self.mcfg.head_dim} is not a width the ragged "
                f"prefill kernel is built for {_SUPPORTED_D}",
            )
        else:
            self._ragged_bq = bq
            per_row = unit
            if self.ecfg.prefix_cache:
                per_row = max(
                    per_row,
                    self.ecfg.min_prefill_bucket
                    * 2 ** max(0, self.ecfg.prefix_tail_buckets - 1),
                )
            per_row = -(-per_row // bq) * bq
            self._ragged_tot = self.ecfg.prefill_rows * per_row
            self._ragged_row_blocks = per_row // bq

    def _align_int4_pages(self) -> None:
        """The packed int4 page-alignment pass, AFTER the mux default so the
        effective segment width is what gets rounded (the reference's): an
        odd ``prefill_chunk`` rounds up to even, and an odd pool page
        fences the prefix cache — packed segment writes and page copies
        must cover whole bytes."""
        if self.ecfg.kv_quant != "int4":
            return
        from p2p_llm_tunnel_tpu_torch.ops.decode_attention import (
            INT4_PACK_TOKENS,
            page_alignment_violations,
        )

        chunk = self.ecfg.prefill_chunk
        if chunk % INT4_PACK_TOKENS:
            fixed = chunk + INT4_PACK_TOKENS - chunk % INT4_PACK_TOKENS
            log.info("rounding prefill_chunk %d up to %d: packed int4 KV "
                     "segments must be page-aligned", chunk, fixed)
            self.ecfg = dc_replace(self.ecfg, prefill_chunk=fixed)
        if self.ecfg.prefix_cache:
            for why in page_alignment_violations(
                    "int4", self.ecfg.min_prefill_bucket,
                    self.ecfg.prefill_chunk):
                self._fence("prefix_cache", False, why)

    def _gate_fused_decode(self) -> None:
        """On the card, fence the fused decode layer when the model's head
        geometry has no instance of the split-KV body that kernels 4 and 5
        share — one new row per slot, or with speculation the widest verify
        burst (the TPU's % 128 tiling gates do not apply here)."""
        from p2p_llm_tunnel_tpu_torch.ops.fused_decode import fence_reason

        cfg = self.mcfg
        if not (self.ecfg.fused_decode_layer and self.device.type == "cuda"):
            return
        burst = self._spec_k_cap() + 1 if self.ecfg.spec_ngram > 0 else 0
        why = fence_reason(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, burst)
        if why is not None:
            self._fence("fused_decode_layer", False, why)
            self.mcfg = dc_replace(self.mcfg, fused_decode_layer=False)

    def _fence(self, knob: str, off, reason: str) -> None:
        """Auto-disable ``knob`` and RECORD it in ``config_fences`` (the
        /healthz ``config`` section) instead of only logging it."""
        log.warning("%s disabled: %s", knob, reason)
        self.config_fences.append({"knob": knob, "reason": reason})
        self.ecfg = dc_replace(self.ecfg, **{knob: off})

    def _reserve_pages(self, req: GenRequest) -> None:
        """Scheduler admission hook: reserve pool pages for the request's
        prompt insert, evicting cost-aware under pressure NOW rather than
        mid-wave.  Pure host work; the grant is advisory accounting, and
        every grant is RELEASED (after the insert lands, or in generate()'s
        finally on any death path)."""
        if self._prefix is None:
            return
        need = len(self._prefix.missing(req.prompt_ids))
        if need <= 0:
            return
        granted = self._prefix.reserve(need)
        if granted:
            self._page_reserved[req.request_id] = granted

    def _release_pages(self, rid: int) -> None:
        """EVENT-LOOP THREAD ONLY, so the reserved-pages counter's
        read-modify-write never interleaves across threads."""
        n = self._page_reserved.pop(rid, None)
        if n and self._prefix is not None:
            self._prefix.release(n)

    def _release_pages_for(self, runs: List[RunningSlot]) -> None:
        """Release the admission grants of runs whose prompt insert just
        landed (loop thread, after the executor insert returned)."""
        for run in runs:
            self._release_pages(run.request.request_id)

    def _note_prefill_cost(self, tokens: int, wall_ms: float) -> None:
        """Per-token prefill-ms EMA: the live estimate cost-aware eviction
        weighs pool pages with."""
        if tokens <= 0 or wall_ms <= 0:
            return
        per = wall_ms / tokens
        ema = self._prefill_ms_per_token
        self._prefill_ms_per_token = per if ema <= 0 else 0.8 * ema + 0.2 * per

    def _conv_insert(self, pending: List[Tuple[int, List[int]]]) -> None:
        """Save finished conversations' full-page KV — prompt AND generated
        tokens — into the pool (executor thread), one batched copy per
        prefill_rows sub-batch."""
        entries = plan_inserts(
            self._prefix, pending, conv=True,
            ms_per_token=self._prefill_ms_per_token or 1.0,
        )
        total = sum(len(ids) for _, ids, _ in entries)
        self._copy_out_entries(entries)
        if total:
            global_metrics.inc("engine_conv_saved_pages_total", total)
            global_metrics.inc("engine_prefix_saved_blocks_total", total)

    async def _drain_conv_inserts(self, loop) -> None:
        """End-of-iteration conversation-cache drain: batch-insert every
        slot _account_token finished this iteration.  It is ENQUEUED on the
        executor (and so on its stream) before the next iteration's
        admission can dispatch a prefill that overwrites the slot's KV —
        the ordering tests/test_torch_mux.py pins."""
        if not self._conv_pending:
            return
        pending, self._conv_pending = self._conv_pending, []
        self._flight_conv = len(pending)
        await loop.run_in_executor(self._executor, self._conv_insert, pending)

    def _publish_prefix_gauges(self) -> None:
        """Prefix-pool memory accounting: pages used/free/reserved,
        resident KV bytes, and the eviction + conversation-cache counters
        (delta-inc from the index's tallies).  Host arithmetic only."""
        if self._prefix is None:
            return
        used = self._prefix.used_blocks
        global_metrics.set_gauge("engine_prefix_pool_blocks_used", used)
        global_metrics.set_gauge(
            "engine_prefix_pool_blocks_free", self._prefix.free_blocks
        )
        global_metrics.set_gauge(
            "engine_prefix_pool_kv_bytes", used * self._prefix_block_bytes
        )
        global_metrics.set_gauge(
            "engine_prefix_pool_pages_reserved", self._prefix.reserved_pages
        )
        for metric, attr in (
            ("engine_prefix_evictions_total", "evictions"),
            ("engine_conv_hits_total", "conv_hits"),
            ("engine_conv_hit_tokens_total", "conv_hit_tokens"),
        ):
            now = getattr(self._prefix, attr)
            delta = now - self._prefix_published.get(attr, 0)
            if delta > 0:
                global_metrics.inc(metric, delta)
                self._prefix_published[attr] = now
        self._thrash_tick()

    def _thrash_tick(self) -> None:
        """One thrash-detector step (one per gauge publish): window the
        (eviction, recent-realloc) deltas, mark the engine degraded
        (reason "memory") on a churn-dominated window, clear on a quiet
        one."""
        ev = self._prefix.evictions
        re_alloc = self._prefix.thrash_reallocs
        d_ev = ev - self._thrash_last[0]
        d_re = re_alloc - self._thrash_last[1]
        self._thrash_last = (ev, re_alloc)
        if d_ev or d_re or self._thrash_window:
            self._thrash_window.append((d_ev, d_re))
        window_re = sum(r for _, r in self._thrash_window)
        window_ev = sum(e for e, _ in self._thrash_window)
        threshold = max(8, self._prefix.capacity - 1)
        if (window_re >= threshold and window_ev >= threshold
                and not self.degraded):
            log.error(
                "memory-thrash detector: %d re-allocations of recently "
                "evicted pages across %d evictions in the detector window; "
                "marking engine degraded (reason=memory)",
                window_re, window_ev,
            )
            global_metrics.inc("engine_thrash_trips_total")
            self.degraded = True
            self.degraded_reason = "memory"
            global_metrics.set_gauge("engine_degraded", 1.0)
            global_metrics.set_info("engine_degraded_reason", "memory")
            global_blackbox.capture("memory", attribution="prefix_pool_thrash")
            self._thrash_window.clear()
        elif (self.degraded and self.degraded_reason == "memory"
                and window_re == 0
                and self._prefix.free_blocks >= self.ecfg.spill_low_water):
            log.info("memory-thrash detector: pressure subsided; "
                     "clearing degraded")
            self.degraded = False
            self.degraded_reason = ""
            global_metrics.set_gauge("engine_degraded", 0.0)
            global_metrics.set_info("engine_degraded_reason", "")

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

    def _flight_record(self, it_t0: float, t_admit: float, t_prefill: float,
                       t_dispatch: float, t_fetch: float, plain_rows: int,
                       seg_rows: int) -> None:
        """One flight-recorder row per non-idle loop iteration: pure host
        bookkeeping over the scratch the iteration's methods stashed."""
        now = time.monotonic()
        slots = self.scheduler.slots
        mux = self._last_mux
        backlog = mux.get("backlog_rows")
        if backlog is None:
            # Non-mux iterations: the row-count proxy (no controller ran).
            backlog = (len(self._segmented) + len(self._pending_plain)
                       + len(self._prefix_waiters))
        pi = self._prefix
        global_flight.record_iteration(
            t=it_t0,
            dur_ms=round((now - it_t0) * 1000.0, 3),
            queue_depth=self.scheduler.queue_depth,
            backlog_rows=int(backlog),
            min_slack_s=mux.get("min_slack_s"),
            budget_tokens=int(mux.get("budget_tokens", 0) or 0),
            admitted=self._flight_admitted,
            prefill_rows=plain_rows + seg_rows,
            decode_steps=self._last_burst[0],
            decode_rows=self._last_burst[1],
            active_slots=sum(1 for s in slots if s is not None),
            tenants=len({run.request.tenant for run in slots if run is not None}),
            waiters=len(self._prefix_waiters),
            prefix_blocks_used=pi.used_blocks if pi is not None else 0,
            prefix_pages_reserved=pi.reserved_pages if pi is not None else 0,
            conv_inserted=self._flight_conv,
            spec_proposed=self._flight_spec[0],
            spec_accepted=self._flight_spec[1],
            spec_k=self._flight_spec[2],
            cold_compiles=0,
            admit_ms=round((t_admit - it_t0) * 1000.0, 3),
            prefill_ms=round((t_prefill - t_admit) * 1000.0, 3),
            dispatch_ms=round((t_dispatch - t_prefill) * 1000.0, 3),
            fetch_ms=round((t_fetch - t_dispatch) * 1000.0, 3),
            process_ms=round((now - t_fetch) * 1000.0, 3),
        )

    async def _dispatch_prefill_work(self, loop) -> Tuple[List, int]:
        """This iteration's prefill work, dispatched before the decode
        burst.  Non-mux: one prefill_rows-wide segment sub-batch.  Mux: the
        controller's budgeted slice — pending whole-prompt rows and/or
        segment sub-batches back to back (their fetches pipeline in
        _finish_segments).  Returns (segment dispatches, plain rows)."""
        segs: List = []
        plain_rows = 0
        if self.ecfg.mux:
            rows_budget = self._mux_budget()
            if self._pending_plain and rows_budget > 0:
                take = min(rows_budget, len(self._pending_plain))
                batch = [r for r in self._pending_plain[:take]
                         if self.scheduler.slots[r.slot] is r]
                del self._pending_plain[:take]
                if batch:
                    await self._dispatch_plain_waves(loop, batch)
                    plain_rows += len(batch)
                rows_budget -= take
            while self._segmented and rows_budget > 0:
                seg = await loop.run_in_executor(
                    self._executor, self._dispatch_segments, rows_budget,
                )
                if seg is None:
                    break
                segs.append(seg)
                rows_budget -= len(seg[0])
        elif self._segmented:
            seg = await loop.run_in_executor(
                self._executor, self._dispatch_segments
            )
            if seg is not None:
                segs.append(seg)
        return segs, plain_rows

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        log.info(
            "engine loop started: model=%s slots=%d max_seq=%d decode_steps=%d "
            "mux=%s prefix_cache=%s ragged=%s device=%s", self.mcfg.name,
            self.ecfg.num_slots, self.ecfg.max_seq, self.ecfg.decode_steps,
            self.ecfg.mux, self.ecfg.prefix_cache, self.ecfg.ragged_prefill,
            self.device,
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
                self._flight_conv = 0
                self._last_burst = (0, 0)
                self._last_mux = {}
                self._flight_spec = (0, 0, 0)
                plain_rows = 0
                global_flight.set_phase("admit")
                self._expire_deadlines()
                if self.ecfg.mux:
                    await self._admit_mux(loop)
                    await self._mux_wake(loop)
                else:
                    # Whole-prompt admission waves run inline: their rows
                    # are this iteration's prefill work.
                    await self._admit_pending(loop)
                    plain_rows += self._flight_admitted
                t_admit = time.monotonic()
                global_metrics.set_gauge("engine_batch_occupancy",
                                         self.scheduler.occupancy)
                global_metrics.set_gauge("engine_queue_depth",
                                         self.scheduler.queue_depth)
                self._publish_prefix_gauges()
                global_flight.set_phase("prefill_dispatch")
                segs, more = await self._dispatch_prefill_work(loop)
                plain_rows += more
                t_prefill = time.monotonic()
                seg_rows = sum(len(s[0]) for s in segs)

                if self._spec_usable() and any(self._active_mask):
                    # Speculative step: a synchronous dispatch + fetch (the
                    # counts must be read before consumers can be fed, so
                    # there is no carry to pipeline).  The in-flight plain
                    # burst drains first.
                    global_flight.set_phase("decode_fetch")
                    if in_flight is not None:
                        pending, assign, t_disp = in_flight
                        outs = await loop.run_in_executor(self._executor,
                                                          pending.get)
                        await self._process_burst(outs, assign)
                        self._trace_burst(t_disp, assign)
                        in_flight = None
                    global_flight.set_phase("decode_dispatch")
                    spec_out, spec_assign = await loop.run_in_executor(
                        self._executor, self._dispatch_spec
                    )
                    t_spec = time.monotonic()
                    global_flight.set_phase("process")
                    await self._process_spec(spec_out, spec_assign)
                    global_flight.set_phase("segments")
                    for seg in segs:
                        await self._finish_segments(loop, seg)
                    await self._drain_conv_inserts(loop)
                    self._flight_record(it_t0, t_admit, t_prefill, t_spec,
                                        t_spec, plain_rows, seg_rows)
                    continue

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
                global_flight.set_phase("segments")
                for seg in segs:
                    # Fetched after the decode dispatch, so each segment
                    # sub-batch's device-to-host copy rides under compute.
                    await self._finish_segments(loop, seg)
                # Conversation-cache inserts for slots that finished this
                # iteration — BEFORE the next admission can re-prefill them.
                await self._drain_conv_inserts(loop)
                in_flight = current
                self._flight_record(it_t0, t_admit, t_prefill, t_dispatch,
                                    t_fetch, plain_rows, seg_rows)
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
