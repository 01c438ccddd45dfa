"""The ``tunnel-gpu`` CLI: serve / proxy / signal subcommands + retry
supervisor (port of p2p_llm_tunnel_tpu/cli.py).

The tunnel plane is the reference's: the same flags, flag > env > default
precedence, the same ``run_with_retry`` backoff and SIGTERM drain.
``serve --backend gpu`` runs the in-process PyTorch engine on the card
(``--device cpu`` runs it on the CPU instead).  Flags of engine features
this slice does not port are accepted only at their off value: anything
else exits with a message naming the ROADMAP.md port-queue item.  Unlike
the JAX serve CLI, mux / prefix cache / conversation cache default OFF —
they are in that queue.
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
    # The JAX serve CLI's engine knobs that this slice does not port:
    # accepted at their off value only (see _unported).
    for flag, kw in _UNPORTED_FLAGS.items():
        serve.add_argument(flag, **kw)

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
    return ap


_BOOL = dict(action=argparse.BooleanOptionalAction, default=False)
#: flag -> argparse kwargs; every default is the off value.
_UNPORTED_FLAGS = {
    "--quant": dict(default="none"),
    "--kv-quant": dict(default="none"),
    "--prefill-act-quant": _BOOL,
    "--mux": _BOOL,
    "--prefix-cache": _BOOL,
    "--conv-cache": _BOOL,
    "--prefix-cache-dir": dict(default=None),
    "--prefill-chunk": dict(type=int, default=0),
    "--ragged-prefill": _BOOL,
    "--fused-decode-layer": _BOOL,
    "--spec-ngram": dict(type=int, default=0),
    "--spill-pages": dict(type=int, default=0),
    "--role": dict(default="both"),
    "--ckpt": dict(default=None),
    "--tp": dict(type=int, default=1),
    "--sp": dict(type=int, default=1),
    "--ep": dict(type=int, default=1),
    "--replicas": dict(type=int, default=1),
    "--coordinator": dict(default=None),
}


def _engine_config(args):
    """The EngineConfig of ``serve --backend gpu``; raises SystemExit with
    the port-queue item for a knob this slice does not run."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import (
        EngineConfig,
        NotPorted,
        check_ported,
    )

    if args.replicas != 1:
        raise SystemExit("--replicas is not ported to the PyTorch engine yet "
                         "(ROADMAP.md, port queue: parallel/)")
    if args.coordinator:
        raise SystemExit("--coordinator is not ported to the PyTorch engine "
                         "yet (ROADMAP.md, port queue: parallel/)")
    ecfg = EngineConfig(
        model=args.model, num_slots=args.slots, max_seq=args.max_seq,
        dtype=args.dtype, decode_steps=args.decode_steps,
        decode_steps_eager=args.decode_steps_eager,
        prefill_rows=args.prefill_rows, tp=args.tp, sp=args.sp, ep=args.ep,
        ckpt_path=args.ckpt, quant=args.quant, kv_quant=args.kv_quant,
        prefill_act_quant=args.prefill_act_quant,
        fused_decode_layer=args.fused_decode_layer,
        prefix_cache=args.prefix_cache,
        prefix_cache_dir=args.prefix_cache_dir,
        conv_cache=args.conv_cache, spill_pages=args.spill_pages,
        spec_ngram=args.spec_ngram, prefill_chunk=args.prefill_chunk,
        ragged_prefill=args.ragged_prefill, mux=args.mux,
        max_waiting=args.max_waiting, fair_admission=args.fair_admission,
        tenant_weights=args.tenant_weights,
        watchdog_budget_s=args.watchdog_budget, role=args.role,
    )
    try:
        check_ported(ecfg)
    except NotPorted as e:
        raise SystemExit(str(e)) from None
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


async def _engine_backend(args):
    """Start (once) the in-process engine and return the request handler;
    reconnects re-use the warm engine."""
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine

    ecfg = _engine_config(args)
    tokenizer = None
    if args.tokenizer:
        from p2p_llm_tunnel_tpu_torch.engine.tokenizer import HFTokenizer

        tokenizer = HFTokenizer(args.tokenizer)
    log.info("starting PyTorch engine: model=%s slots=%d device=%s",
             args.model, args.slots, args.device)
    engine = InferenceEngine(engine_cfg=ecfg, tokenizer=tokenizer,
                             device=args.device)
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


if __name__ == "__main__":
    main()
