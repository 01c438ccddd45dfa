"""Self-contained serve+proxy stack over loopback, runnable as a process.

The server half of the out-of-process ingress load test: one process
hosts the REAL serving path — the PyTorch engine → EngineAPI →
run_serve ⇄ loopback tunnel ⇄ run_proxy → HTTP listener — while
``scripts/loadgen.py`` hammers the listener from a separate process, so
client-side parsing never shares an interpreter (or a GIL) with the stack
under test.  The readiness line

    LOADGEN_STACK_PORT=<port>

is printed on stdout once the engine is warm and the listener is
accepting.

The engine runs on the card unless ``--device cpu`` (env
``TUNNEL_DEVICE``) asks for the CPU; with no card and no such request the
stack exits non-zero before it prints anything.  ``--model`` names a
preset built on random weights from the EngineConfig seed, as
``tunnel-gpu serve`` builds it.  Start it, then point loadgen at its port:

    python -m p2p_llm_tunnel_tpu_torch.testing.local_stack \\
        --model llama3-8b --slots 16 --max-seq 1024 --port 8000
    python scripts/loadgen.py --port 8000 --tenant herd:32:2 --json

Runs until SIGTERM/SIGINT, then stops the engines and exits 0.
TUNNEL_CHAOS wraps the loopback tunnel like any other transport, so the
ingress herd can run under seeded faults.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.transport.chaos import maybe_chaos
from p2p_llm_tunnel_tpu_torch.transport.loopback import loopback_pair
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger, init_logging

log = get_logger(__name__)

#: Readiness line prefix loadgen greps for.
READY_PREFIX = "LOADGEN_STACK_PORT="


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="local_stack",
        description="loopback serve+proxy stack for out-of-process load "
                    "tests",
    )
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP listen port (0 = ephemeral, reported on "
                         "stdout)")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--device", default=os.environ.get("TUNNEL_DEVICE", "cuda"),
                    help="torch device of the engines: cuda (default) or "
                         "cpu (env TUNNEL_DEVICE)")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--max-waiting", type=int, default=600,
                    help="engine admission bound (the fairness cap base)")
    ap.add_argument("--max-inflight", type=int, default=4096,
                    help="serve-layer in-flight bound (sized above the "
                         "herd by default so sheds come from the engine's "
                         "tenant-aware admission)")
    ap.add_argument("--tenant-weights", default=os.environ.get(
        "TUNNEL_TENANT_WEIGHTS", ""))
    ap.add_argument("--no-fair-admission", action="store_true",
                    help="disable tenant-fair admission (the A/B lever "
                         "for the aggressor experiment)")
    ap.add_argument("--prefix-cache", action="store_true",
                    default=os.environ.get("TUNNEL_PREFIX_CACHE") == "1",
                    help="enable the prefix pool (+ conversation cache) — "
                         "the loadgen --turns experiment's server side")
    ap.add_argument("--spill-pages", type=int,
                    default=int(os.environ.get("TUNNEL_SPILL_PAGES", "0")),
                    help="host-RAM KV spill tier capacity in pages "
                         "(0 = off) — the loadgen memory-pressure "
                         "experiment's server side")
    ap.add_argument("--prefix-pool-blocks", type=int,
                    default=int(os.environ.get(
                        "TUNNEL_PREFIX_POOL_BLOCKS", "128")),
                    help="prefix pool capacity in KV blocks (shrink it to "
                         "force spill under a herd)")
    ap.add_argument("--disagg", action="store_true",
                    default=os.environ.get("TUNNEL_DISAGG") == "1",
                    help="disaggregated topology: TWO engines — a "
                         "prefill-role peer and a decode-role peer — "
                         "behind one fabric proxy with prefix-affinity "
                         "routing and KV-page handoff over the tunnel; "
                         "implies --prefix-cache on both engines")
    return ap


def _engine(args, tokenizer=None, **knobs) -> InferenceEngine:
    """An engine of the stack's configuration on ``args.device``; ``knobs``
    are the topology's own EngineConfig fields."""
    return InferenceEngine(engine_cfg=EngineConfig(
        model=args.model,
        num_slots=args.slots,
        max_seq=args.max_seq,
        decode_steps=args.decode_steps,
        max_waiting=args.max_waiting,
        fair_admission=not args.no_fair_admission,
        tenant_weights=args.tenant_weights,
        mux=True,
        prefix_pool_blocks=args.prefix_pool_blocks,
        spill_pages=args.spill_pages,
        watchdog_budget_s=120.0,
        **knobs,
    ), tokenizer=tokenizer, device=args.device)


def _disagg_engine(args, role: str) -> InferenceEngine:
    """One engine of the disaggregated pair.

    Both roles share EVERY numerics-relevant knob — model, seed (the
    EngineConfig default), quant/kv-quant defaults, block geometry, device
    — so pages shipped from the prefill peer pass the decode peer's pin
    check and byte-identity holds.  prefix_cache is forced on: the role
    fence would otherwise bounce the role back to "both"."""
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import Latin1Tokenizer

    return _engine(args, Latin1Tokenizer(), prefix_cache=True,
                   conv_cache=True, role=role)


def _peer_chaos(channel, peer_id: str):
    """Chaos wrap scoped to one peer: with TUNNEL_CHAOS_PEER set, only that
    peer's channels get the TUNNEL_CHAOS schedule — how the chaos matrix
    murders exactly the prefill peer mid-transfer while the decode peer
    (whose fallback is the behavior under test) stays healthy."""
    target = os.environ.get("TUNNEL_CHAOS_PEER", "")
    if target and peer_id != target:
        return channel
    return maybe_chaos(channel)


async def _amain_disagg(args) -> None:
    """Two-engine disaggregated stack: prefill-0 + decode-0 behind one
    fabric proxy.  Same readiness contract as the single-engine stack;
    peer ids are stable so affinity hashes and chaos targeting are
    reproducible across runs."""
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import (
        ProxyState,
        run_proxy_fabric,
    )

    engines = {
        "prefill-0": _disagg_engine(args, "prefill"),
        "decode-0": _disagg_engine(args, "decode"),
    }
    for eng in engines.values():
        await eng.start()
        await eng.warmup()

    state = ProxyState(tenant_fallback="local", trust_tenant_header=True,
                       fabric=True)
    serve_tasks = []
    proxy_task = None
    try:
        for pid, eng in engines.items():
            serve_ch, proxy_ch = loopback_pair()
            serve_ch = _peer_chaos(serve_ch, pid)
            proxy_ch = _peer_chaos(proxy_ch, pid)
            task = asyncio.create_task(run_serve(
                serve_ch, backend=engine_backend(eng, args.model),
                max_inflight=args.max_inflight,
            ))
            # A peer death (chaos kill) must NOT end the stack — the
            # fabric routes around it; that failover IS what chaos runs
            # assert.  Log and carry on; run_proxy_fabric owns liveness.
            task.add_done_callback(lambda t, p=pid: log.warning(
                "serve peer %s exited: %s", p,
                t.exception() if not t.cancelled() else "cancelled",
            ))
            serve_tasks.append(task)
            await state.admit(proxy_ch, pid)
        ready: asyncio.Future = asyncio.get_running_loop().create_future()
        proxy_task = asyncio.create_task(run_proxy_fabric(
            state, "127.0.0.1", args.port, ready=ready,
        ))
        await asyncio.wait({ready, proxy_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if not ready.done():
            proxy_task.result()
            raise RuntimeError("proxy exited before reporting readiness")
        print(f"{READY_PREFIX}{ready.result()}", flush=True)
        await proxy_task
    finally:
        for task in serve_tasks:
            task.cancel()
        if proxy_task is not None:
            proxy_task.cancel()
            serve_tasks.append(proxy_task)
        await asyncio.gather(*serve_tasks, return_exceptions=True)
        for eng in engines.values():
            await eng.stop()


async def amain(args) -> None:
    if args.disagg:
        await _amain_disagg(args)
        return
    tokenizer = None
    if args.prefix_cache:
        # Conversation-replay experiments need the byte<->text mapping to
        # be bijective: random-weight generations are arbitrary bytes,
        # and only a lossless round-trip lets a replayed assistant
        # message re-render to the exact cached token stream.
        from p2p_llm_tunnel_tpu_torch.engine.tokenizer import Latin1Tokenizer

        tokenizer = Latin1Tokenizer()
    engine = _engine(args, tokenizer, prefix_cache=args.prefix_cache,
                     conv_cache=args.prefix_cache)
    await engine.start()
    await engine.warmup()

    serve_ch, proxy_ch = loopback_pair()
    serve_ch = maybe_chaos(serve_ch)
    proxy_ch = maybe_chaos(proxy_ch)
    serve_task = asyncio.create_task(run_serve(
        serve_ch, backend=engine_backend(engine, args.model),
        max_inflight=args.max_inflight,
    ))
    ready: asyncio.Future = asyncio.get_running_loop().create_future()
    proxy_task = asyncio.create_task(run_proxy(
        proxy_ch, "127.0.0.1", args.port, ready=ready,
        tenant_fallback="local",
        # loadgen IS the trusted edge here: it stamps x-tunnel-tenant so
        # server-side series match its --tenant spec names.  A public
        # proxy keeps the default (off) — see --trust-tenant-header.
        trust_tenant_header=True,
    ))
    try:
        # run_proxy resolves ``ready`` only once its listener is accepting;
        # a startup failure (port already bound) stores the exception in
        # proxy_task instead, so waiting on ``ready`` alone would hang this
        # process forever with the bind error swallowed.
        await asyncio.wait({ready, proxy_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if not ready.done():
            proxy_task.result()  # raises the proxy's startup error
            raise RuntimeError("proxy exited before reporting readiness")
        port = ready.result()
        # The contract line loadgen waits for; everything else this
        # process prints goes to stderr via logging.
        print(f"{READY_PREFIX}{port}", flush=True)
        await asyncio.gather(serve_task, proxy_task)
    finally:
        serve_task.cancel()
        proxy_task.cancel()
        await asyncio.gather(serve_task, proxy_task, return_exceptions=True)
        await engine.stop()


async def _until_signalled(args) -> None:
    """``amain`` until it ends or SIGTERM/SIGINT arrives; a signal cancels
    it, which stops the engines, and returns normally."""
    task = asyncio.create_task(amain(args))
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, task.cancel)
    try:
        await task
    except asyncio.CancelledError:
        if not task.cancelled():
            raise
        log.info("local_stack: signalled, engines stopped")


def main(argv=None) -> int:
    init_logging()
    args = build_parser().parse_args(argv)
    asyncio.run(_until_signalled(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
