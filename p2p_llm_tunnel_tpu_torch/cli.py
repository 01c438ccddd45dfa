"""The ``tunnel-gpu`` CLI: serve / proxy / signal / relay subcommands +
retry supervisor (port of p2p_llm_tunnel_tpu/cli.py).

The tunnel plane is the reference's: the same flags, flag > env > default
precedence, the same ``run_with_retry`` backoff and SIGTERM drain.
``serve --backend gpu`` runs the in-process PyTorch engine on the card
(``--device cpu`` runs it on the CPU instead) in the JAX serve CLI's
default engine configuration: mux, prefix cache and conversation cache ON
(``TUNNEL_MUX``, ``TUNNEL_PREFIX_CACHE``, ``TUNNEL_CONV_CACHE``), bf16
weights and KV, ``--ragged-prefill`` off.  ``--tp N --sp M --ep E``
serves one model from N*M*E ranks, one process each (tensor parallelism
over N, sequence-parallel prefill over M with ``--sp-mode
ring|ulysses``, a MoE model's experts over E): with no ``--coordinator``
this process is rank 0 and starts the other ranks on this host itself;
with ``--coordinator host:port --num-processes D*E*N*M --process-id r``
every host runs the same command, rank 0 serves the tunnel and the other
ranks replay its dispatches, and ``--dp-dcn D`` splits the engine's slots
over D data-parallel rank groups (dp outermost, as the JAX CLI's hybrid
mesh).  ``--replicas N`` serves N engines behind a least-loaded router,
replica i on ``cuda:(i % device_count)`` with seed i.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import random
import sys
from typing import Optional

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger, init_logging

log = get_logger(__name__)

INITIAL_BACKOFF = 2.0
MAX_BACKOFF = 60.0

DEFAULT_SIGNAL = os.environ.get("TUNNEL_SIGNAL", "wss://signal-server.fly.dev")
DEFAULT_LISTEN = os.environ.get("TUNNEL_LISTEN", "127.0.0.1:8000")
DEFAULT_UPSTREAM = os.environ.get("TUNNEL_UPSTREAM", "http://127.0.0.1:11434")


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tunnel-gpu", description="P2P LLM tunnel, PyTorch/CUDA edition"
    )
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p: argparse.ArgumentParser) -> None:
        p.add_argument("--signal", default=DEFAULT_SIGNAL,
                       help="signaling server URL (env TUNNEL_SIGNAL)")
        p.add_argument("--room", default=_env("TUNNEL_ROOM"),
                       help="rendezvous room name (env TUNNEL_ROOM)")
        p.add_argument("--transport", choices=("udp", "tcp"),
                       default=_env("TUNNEL_TRANSPORT", "udp"),
                       help="P2P data plane (default udp hole-punch)")
        p.add_argument("--stun", default=_env("TUNNEL_STUN"),
                       help="STUN server host[:port] (env TUNNEL_STUN)")
        p.add_argument("--relay", default=_env("TUNNEL_RELAY"),
                       help="relay host[:port] to fall back to when hole "
                            "punching fails (env TUNNEL_RELAY)")
        p.add_argument("--relay-secret", default=_env("TUNNEL_RELAY_SECRET"),
                       help="shared credential for an authenticated relay "
                            "(env TUNNEL_RELAY_SECRET)")
        p.add_argument("--trace", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_TRACE", "") == "1",
                       help="record request-scope spans; export via GET "
                            "/healthz?trace=1 (env TUNNEL_TRACE=1)")
        p.add_argument("--trace-sample", type=float,
                       default=float(_env("TUNNEL_TRACE_SAMPLE", "1.0")),
                       help="fraction of traces recorded under --trace")
        p.add_argument("--trace-buffer", type=int,
                       default=int(_env("TUNNEL_TRACE_BUFFER", "4096")),
                       help="span ring-buffer capacity under --trace")

    serve = sub.add_parser("serve", help="provider peer: expose an LLM")
    common(serve)
    serve.add_argument("--upstream", default=DEFAULT_UPSTREAM,
                       help="upstream LLM base URL (env TUNNEL_UPSTREAM)")
    serve.add_argument("--advertise", default=_env("TUNNEL_ADVERTISE", "/"),
                       help="path prefix advertised to the peer (default /)")
    serve.add_argument("--backend", choices=("http", "gpu"),
                       default=_env("TUNNEL_BACKEND", "http"),
                       help="http = forward to --upstream; gpu = in-process "
                            "PyTorch engine")
    serve.add_argument("--device", default=_env("TUNNEL_DEVICE", "cuda"),
                       help="torch device of the gpu backend (cuda, cuda:N, "
                            "or cpu; env TUNNEL_DEVICE)")
    serve.add_argument("--model", default=_env("TUNNEL_MODEL", "tiny"),
                       help="model preset for --backend gpu")
    serve.add_argument("--slots", type=int,
                       default=int(_env("TUNNEL_SLOTS", "8")),
                       help="continuous-batching slots")
    serve.add_argument("--max-seq", type=int,
                       default=int(_env("TUNNEL_MAX_SEQ", "512")),
                       help="max context length")
    serve.add_argument("--decode-steps", type=int,
                       default=int(_env("TUNNEL_DECODE_STEPS", "8")),
                       help="decode steps per burst")
    serve.add_argument("--decode-steps-eager", type=int,
                       default=int(_env("TUNNEL_DECODE_STEPS_EAGER", "4")),
                       help="smaller burst while requests wait (0 = off)")
    serve.add_argument("--prefill-rows", type=int,
                       default=int(_env("TUNNEL_PREFILL_ROWS", "8")),
                       help="rows per batched-prefill wave")
    serve.add_argument("--dtype", default=_env("TUNNEL_DTYPE", "bfloat16"),
                       help="weight/activation dtype (bfloat16|float32)")
    serve.add_argument("--max-waiting", type=int,
                       default=int(_env("TUNNEL_MAX_WAITING", "64")),
                       help="max queued requests before 429 (0 = unbounded)")
    serve.add_argument("--fair-admission",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_FAIR_ADMISSION", "1") == "1",
                       help="tenant-fair admission (default ON)")
    serve.add_argument("--tenant-weights",
                       default=_env("TUNNEL_TENANT_WEIGHTS", ""),
                       help="fairness weights as name=weight,...")
    serve.add_argument("--max-inflight", type=int,
                       default=int(_env("TUNNEL_MAX_INFLIGHT", "256")),
                       help="max concurrently-dispatched requests before 429")
    serve.add_argument("--drain-timeout", type=float,
                       default=float(_env("TUNNEL_DRAIN_TIMEOUT", "0")),
                       help="seconds a SIGTERM drain waits (0 = forever)")
    serve.add_argument("--stream-grace-s", type=float,
                       default=float(_env("TUNNEL_STREAM_GRACE_S", "5")),
                       help="mid-stream resume grace (0 disables resume)")
    serve.add_argument("--stream-journal-bytes", type=int,
                       default=int(_env("TUNNEL_STREAM_JOURNAL_BYTES",
                                        str(512 * 1024))),
                       help="per-stream replay-journal cap in bytes")
    serve.add_argument("--postmortem-dir",
                       default=_env("TUNNEL_POSTMORTEM_DIR",
                                    "artifacts/postmortem"),
                       help="where postmortem bundles are archived "
                            "(empty disables)")
    serve.add_argument("--watchdog-budget", type=float,
                       default=float(_env("TUNNEL_WATCHDOG_BUDGET", "60")),
                       help="decode-stall watchdog budget in seconds (0 = off)")
    serve.add_argument("--tokenizer", default=_env("TUNNEL_TOKENIZER"),
                       help="HF tokenizer path (default: byte-level)")
    serve.add_argument("--slo", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_SLO", "1") == "1",
                       help="evaluate SLO burn rates (default ON)")
    serve.add_argument("--slo-ttft-ms", type=float,
                       default=float(_env("TUNNEL_SLO_TTFT_MS", "2000")))
    serve.add_argument("--slo-ttft-target", type=float,
                       default=float(_env("TUNNEL_SLO_TTFT_TARGET", "0.99")))
    serve.add_argument("--slo-availability-target", type=float,
                       default=float(_env("TUNNEL_SLO_AVAIL_TARGET", "0.999")))
    serve.add_argument("--fabric", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_FABRIC", "") == "1",
                       help="join as one serve peer of a multi-peer fabric")
    # The JAX serve CLI's default engine: mux + prefix pool + conversation
    # cache ON, with the reference's flags, env names and defaults.
    serve.add_argument("--mux", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_MUX", "1") == "1",
                       help="iteration-level prefill/decode multiplexing "
                            "(default ON; --no-mux or TUNNEL_MUX=0 disables)")
    serve.add_argument("--mux-budget-tokens", type=int,
                       default=int(_env("TUNNEL_MUX_BUDGET_TOKENS", "0")),
                       help="fixed per-iteration prefill token budget under "
                            "--mux (0 = adaptive controller)")
    serve.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_PREFIX_CACHE", "1") == "1",
                       help="automatic prefix caching (default ON; "
                            "--no-prefix-cache or TUNNEL_PREFIX_CACHE=0)")
    serve.add_argument("--prefix-pool-blocks", type=int,
                       default=int(_env("TUNNEL_PREFIX_POOL_BLOCKS", "128")),
                       help="prefix-cache pool capacity in KV blocks "
                            "(block 0 is scratch)")
    serve.add_argument("--spill-pages", type=int,
                       default=int(_env("TUNNEL_SPILL_PAGES", "0")),
                       help="host-RAM spill tier capacity in KV pages "
                            "(0 = off); cold pages migrate out of the "
                            "card's pool under pressure and splice back "
                            "on reuse")
    serve.add_argument("--role",
                       choices=["both", "prefill", "decode"],
                       default=_env("TUNNEL_ROLE", "both"),
                       help="disaggregated serving role: 'prefill' peers "
                            "take proxy export probes and ship KV pages "
                            "over the tunnel; 'decode' peers splice "
                            "shipped pages and stream tokens; 'both' "
                            "(default) serves classic single-engine")
    serve.add_argument("--prefix-cache-dir",
                       default=_env("TUNNEL_PREFIX_CACHE_DIR"),
                       help="persist the prefix-cache block pool here: warm "
                            "prompt KV survives serve restarts (loaded at "
                            "startup when compatible, saved at shutdown)")
    serve.add_argument("--conv-cache", action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_CONV_CACHE", "1") == "1",
                       help="cross-request conversation cache (default ON "
                            "with --prefix-cache; --no-conv-cache or "
                            "TUNNEL_CONV_CACHE=0)")
    serve.add_argument("--prefix-evict", choices=("cost", "lru"),
                       default=_env("TUNNEL_PREFIX_EVICT", "cost"),
                       help="pool page eviction policy: cost (GreedyDual "
                            "over recompute cost) or lru")
    serve.add_argument("--prefill-chunk", type=int,
                       default=int(_env("TUNNEL_PREFILL_CHUNK", "0")),
                       help="chunked prefill segment width (0 = whole-prompt "
                            "prefill; mux picks 128)")
    serve.add_argument("--ragged-prefill",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_RAGGED_PREFILL", "") == "1",
                       help="route every chunk-prefill dispatch through the "
                            "ragged grouped prefill kernel (default off)")
    serve.add_argument("--quant", choices=("none", "int8", "w8a8", "int4"),
                       default=_env("TUNNEL_QUANT", "none"),
                       help="weight quantization: int8 halves the decode "
                            "weight stream; w8a8 also quantizes activations "
                            "(int8 tensor-core products); int4 packs two "
                            "weights per byte with per-group scales, halving "
                            "it again (all through the dequant-fused matmul "
                            "kernel)")
    serve.add_argument("--ckpt", default=_env("TUNNEL_CKPT"),
                       help="checkpoint directory written by this package's "
                            "models.checkpoint.save_checkpoint (convert an HF "
                            "export with convert_hf first); unlike the JAX "
                            "package's --ckpt it reads no orbax directory "
                            "(default: random init)")
    serve.add_argument("--quant-group-size", type=int,
                       default=int(_env("TUNNEL_QUANT_GROUP_SIZE", "128")),
                       help="int4 scale group size (contracted positions "
                            "per f32 scale; must be even)")
    serve.add_argument("--prefill-act-quant",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_PREFILL_ACT_QUANT", "") == "1",
                       help="with --quant int8: run PREFILL activations int8 "
                            "too; decode stays weight-only "
                            "(--no-prefill-act-quant overrides the env)")
    serve.add_argument("--kv-quant", choices=("none", "int8", "int4"),
                       default=_env("TUNNEL_KV_QUANT", "none"),
                       help="KV-cache storage: int8 halves, int4 (two tokens "
                            "per byte) quarters the KV read stream; per-"
                            "(token, head) f32 scales; pool pages follow")
    serve.add_argument("--fused-decode-layer",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_FUSED_DECODE", "") == "1",
                       help="fused decode-layer kernel: rope + new-row KV "
                            "quantization + in-place cache append + "
                            "attention in one launch per layer")
    serve.add_argument("--spec-ngram", type=int,
                       default=int(_env("TUNNEL_SPEC_NGRAM", "0")),
                       help="prompt-lookup speculative decoding: match "
                            "length (0 = off); exact-greedy verification, "
                            "output identical to plain decode")
    serve.add_argument("--spec-k", type=int,
                       default=int(_env("TUNNEL_SPEC_K", "4")),
                       help="speculative proposal length per step")
    serve.add_argument("--spec-k-max", type=int,
                       default=int(_env("TUNNEL_SPEC_K_MAX", "0")),
                       help="adaptive verify-burst cap: when > --spec-k, "
                            "each dispatch picks K from a power-of-two "
                            "ladder up to this cap, steered by the per-slot "
                            "acceptance EMA (0 = fixed K)")
    serve.add_argument("--flash-decode",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_FLASH_DECODE", "") == "1",
                       help="accepted for the JAX serve CLI's command lines; "
                            "chooses nothing on the card, where decode always "
                            "runs the hand-written attention kernels")
    serve.add_argument("--flash-sgrid",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_FLASH_SGRID", "") == "1",
                       help="accepted for the JAX serve CLI's command lines; "
                            "chooses nothing on the card")
    # Parallelism: the JAX serve CLI's flags, env names and defaults.
    serve.add_argument("--tp", type=int, default=int(_env("TUNNEL_TP", "1")),
                       help="tensor-parallel degree: ranks (processes) that "
                            "serve one model, each holding 1/tp of its heads "
                            "and FFN")
    serve.add_argument("--sp", type=int, default=int(_env("TUNNEL_SP", "1")),
                       help="sequence-parallel degree for prefill "
                            "(long-context): ranks that each prefill one "
                            "block of the prompt")
    serve.add_argument("--sp-mode", choices=("ring", "ulysses"),
                       default=_env("TUNNEL_SP_MODE", "ring"),
                       help="SP strategy: ring (K/V blocks passed around "
                            "the ranks) or ulysses (all-to-all; supports "
                            "sliding windows)")
    serve.add_argument("--ep", type=int, default=int(_env("TUNNEL_EP", "1")),
                       help="expert-parallel degree: a MoE model's experts "
                            "split over this many ranks")
    serve.add_argument("--replicas", type=int,
                       default=int(_env("TUNNEL_REPLICAS", "1")),
                       help="data-parallel engine replicas behind a router, "
                            "one per card round-robin")
    serve.add_argument("--coordinator",
                       default=_env("TUNNEL_COORDINATOR")
                       or _env("MEGASCALE_COORDINATOR_ADDRESS"),
                       help="multi-process: torch.distributed rendezvous "
                            "host:port; run the same serve command for "
                            "every rank (env TUNNEL_COORDINATOR; a rank's "
                            "card is cuda:(LOCAL_RANK % cards), NCCL when "
                            "the LOCAL_WORLD_SIZE ranks of a host each have "
                            "one — torchrun's names, defaults --process-id "
                            "and --num-processes)")
    serve.add_argument("--num-processes", type=int,
                       default=int(_env("TUNNEL_NUM_PROCESSES", "0")),
                       help="multi-process: total rank count")
    serve.add_argument("--process-id", type=int,
                       default=int(_env("TUNNEL_PROCESS_ID", "-1")),
                       help="multi-process: this process's rank")
    serve.add_argument("--dp-dcn", type=int,
                       default=int(_env("TUNNEL_DP_DCN", "1")),
                       help="data-parallel degree across hosts: with "
                            "--coordinator, the engine's slots split over "
                            "this many rank groups (dp outermost)")

    proxy = sub.add_parser("proxy", help="consumer peer: local HTTP port")
    common(proxy)
    proxy.add_argument("--listen", default=DEFAULT_LISTEN,
                       help="local HTTP listen addr (env TUNNEL_LISTEN)")
    proxy.add_argument("--peers", type=int,
                       default=int(_env("TUNNEL_PEERS", "1")),
                       help="multi-peer fabric: fan requests across up to "
                            "this many serve peers")
    proxy.add_argument("--peer-probe-s", type=float,
                       default=float(_env("TUNNEL_PEER_PROBE_S", "15")),
                       help="fabric health-probe interval (0 = RTT only)")
    proxy.add_argument("--trust-tenant-header",
                       action=argparse.BooleanOptionalAction,
                       default=_env("TUNNEL_TRUST_TENANT_HEADER", "") == "1",
                       help="honor a client-sent x-tunnel-tenant")

    sig = sub.add_parser("signal", help="run the rendezvous server")
    sig.add_argument("--listen", default="127.0.0.1")
    sig.add_argument("--port", type=int, default=8787)
    sig.add_argument("--stun-port", type=int,
                     default=int(_env("TUNNEL_STUN_PORT", "0")),
                     help="also answer STUN binding requests (0 = off)")

    rly = sub.add_parser("relay", help="run the UDP pairing relay "
                                       "(TURN-equivalent fallback)")
    rly.add_argument("--listen", default="0.0.0.0")
    rly.add_argument("--port", type=int, default=3479)
    rly.add_argument("--secret", default=_env("TUNNEL_RELAY_SECRET"),
                     help="require HMAC-authenticated JOINs with this shared "
                          "credential (env TUNNEL_RELAY_SECRET)")
    return ap


def _check_parallel_flags(args) -> None:
    """The JAX serve CLI's refusals of parallel flag sets, and the port's
    one-process-per-rank rule; raises SystemExit.  ``--dp-dcn`` builds a
    mesh only in a ``--coordinator`` run, as in the JAX CLI."""
    if args.coordinator and (args.num_processes <= 0 or args.process_id < 0):
        # A partial flag set must error loudly, not silently start an
        # independent single-host server for every rank.
        raise SystemExit(
            "--coordinator requires --num-processes > 0 and "
            "--process-id >= 0 (or TUNNEL_NUM_PROCESSES / "
            "TUNNEL_PROCESS_ID)"
        )
    world = args.dp_dcn * args.ep * args.tp * args.sp
    if args.coordinator and args.num_processes != world:
        axes = [f"--tp {args.tp}", f"--sp {args.sp}"] + [
            f"{flag} {n}" for flag, n in (("--ep", args.ep),
                                          ("--dp-dcn", args.dp_dcn)) if n > 1]
        raise SystemExit(
            f"--coordinator runs one process per rank of the mesh: "
            f"--num-processes {args.num_processes} must equal "
            f"{' x '.join(axes)} = {world}"
        )
    if args.replicas > 1:
        if args.coordinator and args.num_processes > 1:
            raise SystemExit(
                "--replicas > 1 is a single-host data-parallel mode; "
                "multi-host runs shard ONE engine over the global mesh"
            )
        if args.tp > 1 or args.sp > 1 or args.ep > 1:
            raise SystemExit(
                "--replicas > 1 with --tp, --sp or --ep > 1 is not supported "
                "by the PyTorch engine: each replica would need a rank group "
                "of its own"
            )


def _engine_config(args, seed: int = 0):
    """The EngineConfig of ``serve --backend gpu`` (replica ``seed`` of a
    ``--replicas`` run snapshots into ``replica-<seed>/``); raises
    SystemExit for a parallel flag set the port refuses."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig

    _check_parallel_flags(args)
    pfx_dir = args.prefix_cache_dir
    if pfx_dir and args.replicas > 1:
        # One shared directory would have every save clobber the previous
        # replica's pool.
        pfx_dir = os.path.join(pfx_dir, f"replica-{seed}")
    ecfg = EngineConfig(
        model=args.model, num_slots=args.slots, max_seq=args.max_seq,
        dtype=args.dtype, decode_steps=args.decode_steps,
        decode_steps_eager=args.decode_steps_eager,
        prefill_rows=args.prefill_rows, tp=args.tp, sp=args.sp,
        sp_mode=args.sp_mode, ep=args.ep,
        ckpt_path=args.ckpt, quant=args.quant,
        quant_group_size=args.quant_group_size, kv_quant=args.kv_quant,
        prefill_act_quant=args.prefill_act_quant,
        flash_decode=args.flash_decode, flash_sgrid=args.flash_sgrid,
        fused_decode_layer=args.fused_decode_layer,
        prefix_cache=args.prefix_cache,
        prefix_cache_dir=pfx_dir,
        prefix_pool_blocks=args.prefix_pool_blocks,
        conv_cache=args.conv_cache and args.prefix_cache,
        prefix_evict=args.prefix_evict, spill_pages=args.spill_pages,
        spec_ngram=args.spec_ngram, spec_k=args.spec_k,
        spec_k_max=args.spec_k_max, prefill_chunk=args.prefill_chunk,
        ragged_prefill=args.ragged_prefill, mux=args.mux,
        mux_budget_tokens=args.mux_budget_tokens,
        max_waiting=args.max_waiting, fair_admission=args.fair_admission,
        tenant_weights=args.tenant_weights,
        watchdog_budget_s=args.watchdog_budget, role=args.role, seed=seed,
    )
    return ecfg


async def run_with_retry(name: str, attempt_fn, *, max_attempts: int = 0,
                         stop: "Optional[asyncio.Event]" = None) -> None:
    """Run ``attempt_fn()`` forever, reconnecting with capped, jittered
    exponential backoff; ``stop`` (the drain switch) ends the loop."""
    import time as _time

    attempt = 0
    while True:
        if stop is not None and stop.is_set():
            log.info("%s: drain requested; not reconnecting", name)
            return
        attempt += 1
        started = _time.monotonic()
        try:
            log.info("%s: connecting (attempt %d)", name, attempt)
            await attempt_fn()
            log.info("%s ended cleanly", name)
            return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("%s failed: %s", name, e)
        if _time.monotonic() - started > MAX_BACKOFF:
            attempt = 1
        if max_attempts and attempt >= max_attempts:
            raise RuntimeError(f"{name}: giving up after {attempt} attempts")
        backoff = min(INITIAL_BACKOFF * (2 ** (attempt - 1)), MAX_BACKOFF)
        backoff *= 1.0 + random.uniform(0.0, 0.25)
        log.info("%s: reconnecting in %.0fs", name, backoff)
        if stop is None:
            await asyncio.sleep(backoff)
        else:
            try:
                await asyncio.wait_for(stop.wait(), backoff)
            except asyncio.TimeoutError:
                pass


_BACKEND = None
#: Ranks 1..N-1 of a one-host run of N = tp * sp ranks
#: (parallel.distributed LocalFollowers), started by this process.
_FOLLOWERS = None


def _tokenizer(spec):
    """A tokenizer from ``--tokenizer`` (a path) or None (byte-level)."""
    if not spec:
        return None
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import HFTokenizer

    return HFTokenizer(spec)


def _join_ranks(args, tokenizer):
    """Join this process to the run ``--tp``/``--sp``/``--ep``/
    ``--coordinator`` ask for and return (mesh, this rank's device), or
    (None, ``--device``) for a one-process run.  Without ``--coordinator``
    a ``--tp N --sp M --ep E`` run is ranks 0..N*M*E-1 of this host: this
    process is rank 0 and starts the others, after building every kernel
    (the card) so no two ranks run nvcc into one build directory; there
    ``--dp-dcn`` builds no mesh, as in the JAX CLI."""
    global _FOLLOWERS
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    if args.coordinator:
        local = pd.env_local_world_size()
        local_rank = int(os.environ.get("LOCAL_RANK", args.process_id))
        dev = pd.rank_device(args.device, local_rank)
        pd.init_distributed(args.coordinator, args.num_processes,
                            args.process_id, device=dev,
                            local_world_size=local)
        return pd.make_hybrid_mesh(tp=args.tp, dp_dcn=args.dp_dcn,
                                   sp=args.sp, ep=args.ep), dev
    world = args.tp * args.sp * args.ep
    if world <= 1:
        return None, args.device
    ecfg = _engine_config(args)
    coordinator = pd.local_rendezvous()
    pd.build_before_launch(args.device)
    log.info("starting %d local follower ranks for --tp %d --sp %d --ep %d",
             world - 1, args.tp, args.sp, args.ep)
    _FOLLOWERS = pd.launch_local_followers(world, lambda r: pd.FollowerSpec(
        coordinator=coordinator, world=world, rank=r, device=args.device,
        engine_cfg=ecfg, tokenizer=args.tokenizer or tokenizer))
    dev = pd.rank_device(args.device, 0)
    pd.init_distributed(coordinator, world, 0, device=dev)
    return pd.make_mesh(tp=args.tp, sp=args.sp, ep=args.ep), dev


async def _engine_backend(args):
    """Start (once) the in-process engine(s) and return the request
    handler; reconnects re-use the warm engine.  A follower rank replays
    rank 0's dispatches here until rank 0 stops, and returns None: it
    opens no tunnel."""
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine

    _engine_config(args)  # refuse a bad flag set before joining anything
    tokenizer = _tokenizer(args.tokenizer)
    if args.replicas > 1:
        from p2p_llm_tunnel_tpu_torch.engine.router import (
            ReplicaRouter,
            router_backend,
        )
        from p2p_llm_tunnel_tpu_torch.parallel.distributed import rank_device

        log.info("starting %d engine replicas: model=%s slots=%d",
                 args.replicas, args.model, args.slots)
        router = ReplicaRouter([
            InferenceEngine(engine_cfg=_engine_config(args, seed=i),
                            tokenizer=tokenizer,
                            device=rank_device(args.device, i))
            for i in range(args.replicas)
        ], args.model)
        await router.start()
        for eng in router.engines:
            await eng.warmup()
        _BACKEND = router_backend(router)
        return _BACKEND
    mesh, device = _join_ranks(args, tokenizer)
    log.info("starting PyTorch engine: model=%s slots=%d device=%s mesh=%s",
             args.model, args.slots, device,
             None if mesh is None else mesh.shape)
    engine = InferenceEngine(engine_cfg=_engine_config(args),
                             tokenizer=tokenizer, device=device, mesh=mesh)
    spmd = engine._spmd
    if spmd is not None and spmd.rank != 0:
        # Follower rank: no tunnel endpoint here — rank 0 owns the tunnel
        # and broadcasts every dispatch's host inputs.
        log.info("follower rank %d: replaying rank 0's dispatches", spmd.rank)
        await asyncio.to_thread(engine.spmd_follower_loop)
        return None
    await engine.start()
    # Builds the CUDA kernels and runs one burst and one wave before
    # traffic, so no request pays for either.
    await engine.warmup()
    _BACKEND = engine_backend(engine, args.model)
    return _BACKEND


async def _serve_once(args, drain: "Optional[asyncio.Event]" = None) -> None:
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.transport import connect

    backend = None
    if args.backend == "gpu":
        backend = await _engine_backend(args)
        if backend is None:
            return  # a follower rank: rank 0 has stopped
    channel, signaling = await connect(
        args.signal, args.room, args.transport,
        stun_server=args.stun, relay=args.relay,
        relay_secret=args.relay_secret,
        role="serve" if args.fabric else None,
    )
    try:
        kwargs = dict(
            max_inflight=args.max_inflight, drain=drain,
            drain_timeout=args.drain_timeout,
            stream_grace_s=args.stream_grace_s,
            stream_journal_bytes=args.stream_journal_bytes,
        )
        if backend is not None:
            await run_serve(channel, backend=backend, **kwargs)
        else:
            await run_serve(channel, args.upstream, args.advertise, **kwargs)
    finally:
        channel.close()
        await signaling.close()


async def _proxy_once(args) -> None:
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.transport import connect

    host, _, port = args.listen.rpartition(":")
    if args.peers > 1:
        await _proxy_fabric_once(args, host or "127.0.0.1", int(port))
        return
    channel, signaling = await connect(args.signal, args.room, args.transport,
                                       stun_server=args.stun, relay=args.relay,
                                       relay_secret=args.relay_secret)
    try:
        await run_proxy(channel, host or "127.0.0.1", int(port),
                        tenant_fallback=args.room or "",
                        trust_tenant_header=args.trust_tenant_header)
    finally:
        channel.close()
        await signaling.close()


async def _proxy_fabric_once(args, host: str, port: int) -> None:
    """One fabric session: a role-tagged proxy fanning requests across up
    to ``--peers`` serve peers."""
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import ProxyState, run_proxy_fabric
    from p2p_llm_tunnel_tpu_torch.transport.fabric import run_fabric_dialer

    state = ProxyState(
        tenant_fallback=args.room or "",
        trust_tenant_header=args.trust_tenant_header,
        probe_interval=args.peer_probe_s,
        fabric=True,
    )
    dialer = asyncio.create_task(run_fabric_dialer(
        args.signal, args.room, args.transport, state,
        max_peers=args.peers, stun_server=args.stun,
        relay=args.relay, relay_secret=args.relay_secret,
    ))
    try:
        await run_proxy_fabric(state, host, port)
    finally:
        dialer.cancel()
        try:
            await dialer
        except asyncio.CancelledError:
            pass
        except Exception as e:
            log.warning("proxy fabric dialer failed: %s", e)
            raise


async def _amain(args) -> None:
    if args.command == "signal":
        from p2p_llm_tunnel_tpu_torch.signaling.server import SignalServer

        if args.stun_port:
            from p2p_llm_tunnel_tpu_torch.transport.stun import start_stun_server

            await start_stun_server(args.listen, args.stun_port)
        await SignalServer(args.listen, args.port).serve_forever()
        return

    if args.command == "relay":
        from p2p_llm_tunnel_tpu_torch.transport.relay import run_relay_server

        await run_relay_server(args.listen, args.port, args.secret)
        return

    if not args.room:
        raise SystemExit("--room (or TUNNEL_ROOM) is required")
    if args.trace:
        from p2p_llm_tunnel_tpu_torch.utils.tracing import global_tracer

        global_tracer.configure(enabled=True, capacity=args.trace_buffer,
                                sample=args.trace_sample)
    if args.command == "serve":
        import signal as _signal

        from p2p_llm_tunnel_tpu_torch.utils.flight import global_blackbox
        from p2p_llm_tunnel_tpu_torch.utils.slo import (
            default_objectives,
            global_slo,
        )

        if args.backend == "gpu":
            _engine_config(args)  # reject unported knobs before connecting
        global_blackbox.configure(directory=args.postmortem_dir or "")
        global_slo.configure(
            enabled=args.slo,
            objectives=default_objectives(
                ttft_ms=args.slo_ttft_ms,
                ttft_target=args.slo_ttft_target,
                availability_target=args.slo_availability_target,
            ),
        )
        # Graceful drain: the first SIGTERM stops admission and lets
        # in-flight streams finish; a second one force-exits.
        drain = asyncio.Event()

        def _drain_now() -> None:
            if drain.is_set():
                log.warning("second SIGTERM: exiting immediately")
                _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                os.kill(os.getpid(), _signal.SIGTERM)
            log.info("SIGTERM: draining (finishing in-flight requests)")
            drain.set()

        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(_signal.SIGTERM, _drain_now)
        except (NotImplementedError, RuntimeError):
            pass
        try:
            await run_with_retry(
                "serve", lambda: _serve_once(args, drain), stop=drain
            )
        finally:
            try:
                loop.remove_signal_handler(_signal.SIGTERM)
            except (NotImplementedError, RuntimeError, ValueError):
                pass
    elif args.command == "proxy":
        await run_with_retry("proxy", lambda: _proxy_once(args))


def main(argv: Optional[list] = None) -> None:
    init_logging()
    args = build_parser().parse_args(argv)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        log.info("interrupted, shutting down")
        sys.exit(130)
    finally:
        if _FOLLOWERS is not None:
            # Rank 0 is gone: its followers wait on its next op; kill them
            # after a short grace instead of their collective timeout.
            _FOLLOWERS.close(timeout_s=5.0)


if __name__ == "__main__":
    main()
