"""Rank bodies of the port's multi-process CPU tests (tensor and sequence
parallelism, SPMD serving), and the tunnel traffic both packages' engines
are driven with.

``run_ranks`` spawns one process per rank (a fresh interpreter each, the
``spawn`` start method), joins them into one gloo world through a file
under the test's ``tmp_path`` (so xdist workers never share a port), runs
one of this module's rank functions in each and returns their results.
Every wait has a timeout: a rank that fails or hangs fails the test, the
other ranks are killed, and no process outlives the call.

This module imports no JAX: the ranks import only the port.  The tests
hand it numpy trees (quantized leaves as ``SimpleNamespace``s with the
reference's attribute names).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import multiprocessing
import queue
import time
import traceback
import uuid

import numpy as np

#: Seconds a collective may block inside a rank before it raises.
RANK_TIMEOUT_S = 60.0
#: The rendezvous URL of the run this spawned rank joined (set by _entry).
RENDEZVOUS = None


def run_ranks(fn_name: str, world: int, payload, tmp_path,
              timeout_s: float = 240.0) -> list:
    """``fn_name(rank, world, payload)`` in ``world`` spawned ranks; the
    per-rank results in rank order.  Raises with the failing rank's
    traceback, or on a timeout."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp_path}/rendezvous-{fn_name}-{uuid.uuid4().hex}"
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, world, init, fn_name, payload, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise AssertionError(
                    f"{fn_name}: ranks {sorted(set(range(world)) - set(out))} "
                    f"gave no result within {timeout_s:.0f} s") from None
            if not ok:
                raise AssertionError(f"{fn_name}: rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(10.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    return [out[r] for r in range(world)]


def _entry(rank, world, init, fn_name, payload, results) -> None:
    import torch

    torch.set_num_threads(1)
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    global RENDEZVOUS
    RENDEZVOUS = init
    try:
        pd.init_distributed(init, world, rank, device="cpu",
                            timeout_s=RANK_TIMEOUT_S)
        value = globals()[fn_name](rank, world, payload)
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        pd.shutdown_distributed()


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def model_logits(rank, world, payload):
    """Each case: prefill two prompts into slots 0 and 1, then one decode
    step, under a ``tp = world`` mesh on this rank's shard; returns
    ``(prefill last logits, decode logits)`` per case."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
        params_from_numpy_sharded,
        shard_kv_cache,
    )

    mesh = make_mesh(tp=world)
    out = {}
    with torch.inference_mode():
        for name, case in payload.items():
            cfg = get_config(case["preset"], **case["overrides"])
            dtype = getattr(torch, case["dtype"])
            params = params_from_numpy_sharded(case["params"], cfg, mesh, "cpu",
                                               dtype)
            cache = shard_kv_cache(
                tt.init_kv_cache(cfg, case["slots"], case["seq"], dtype,
                                 quant=case.get("kv_quant"), device="cpu"),
                mesh)
            last, cache = tt.prefill_into_cache(
                cfg, params, torch.from_numpy(case["tokens"]),
                torch.from_numpy(case["lengths"]), cache,
                torch.from_numpy(case["slot_idx"]), mesh=mesh)
            logits, _ = tt.decode_step(
                cfg, params, cache, torch.from_numpy(case["dec_tokens"]),
                torch.from_numpy(case["dec_pos"]), mesh=mesh)
            out[name] = (last.float().numpy(), logits.float().numpy())
    return out


# ---------------------------------------------------------------------------
# engines through the tunnel
# ---------------------------------------------------------------------------

SYSTEM = b"You are the tunnel's terse assistant; reply in numbers only. "
N_CONV = 3


def first_turns():
    return [list(SYSTEM) + list(f"question {i}: ".encode() * (2 + i))
            for i in range(N_CONV)]


@contextlib.asynccontextmanager
async def tunnel_stack(engine, backend, serve, proxy, pair, model="tiny"):
    """``run_serve`` + ``run_proxy`` over a loopback pair in front of a
    started engine (either package's pieces); yields the proxy's URL."""
    await engine.start()
    serve_ch, proxy_ch = pair()
    ready = asyncio.get_running_loop().create_future()
    tasks = [asyncio.create_task(serve(serve_ch, backend=backend(engine, model))),
             asyncio.create_task(proxy(proxy_ch, "127.0.0.1", 0, ready=ready))]
    try:
        yield f"http://127.0.0.1:{await asyncio.wait_for(ready, 10.0)}"
    finally:
        for t in tasks:
            t.cancel()
        serve_ch.close()
        await asyncio.gather(*tasks, return_exceptions=True)
        await engine.stop()


async def turn(base: str, prompt_ids, max_tokens: int, ndjson: bool):
    """One streamed request through the proxy; (generated ids, finish)."""
    from p2p_llm_tunnel_tpu_torch.endpoints import http11

    if ndjson:
        path, sep = "/api/generate", b"\n"
        body = {"prompt": bytes(prompt_ids).decode("ascii"),
                "max_new_tokens": max_tokens, "ignore_eos": True}
    else:
        path, sep = "/v1/completions", b"\n\n"
        body = {"prompt": list(prompt_ids), "max_tokens": max_tokens,
                "stream": True, "ignore_eos": True}
    resp = await http11.http_request(
        "POST", base + path, {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=120.0)
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status}")
    raw = await resp.read_all()
    text, last = "", None
    for line in raw.split(sep):
        line = line.strip()
        if not line or line == b"data: [DONE]":
            continue
        if line.startswith(b"data: "):
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            text += choice.get("text") or ""
            last = choice.get("finish_reason") or last
        else:
            obj = json.loads(line)
            text += obj.get("response", "")
            last = obj.get("done_reason") or last
    return [int(t) for t in text.split()], last


async def conversations(base: str, max_tokens: int = 8):
    """``N_CONV`` concurrent first turns sharing a system prompt (SSE and
    NDJSON alternating), then their second turns (turn 1 + answer + a new
    tail)."""
    firsts = first_turns()
    one = await asyncio.gather(*[
        turn(base, p, max_tokens + i, ndjson=i % 2 == 1)
        for i, p in enumerate(firsts)])
    seconds = [p + ids + list(b" and then?") for p, (ids, _) in zip(firsts, one)]
    two = await asyncio.gather(*[turn(base, p, 4, ndjson=False) for p in seconds])
    return one + two


def _record(engine, log):
    """Wrap the engine's dispatch methods so every call's sampled ids land
    in ``log`` (rank 0's dispatches and a follower's replays alike: both
    look the methods up on the engine)."""
    for name in ("_decode_fn", "_prefill_fn", "_chunk_prefill_fn",
                 "_spec_verify_fn"):
        fn = getattr(engine, name)

        def call(*a, _fn=fn, _name=name):
            out = _fn(*a)
            log.append((_name, np.asarray(out[0]).tolist()))
            return out

        setattr(engine, name, call)


def engine_streams(rank, world, payload):
    """Each job builds a ``tp = world`` engine (or the job's own ``tp x sp``
    mesh of ``world`` ranks) on the given weights (the engine shards them)
    and serves the conversations through the port's
    tunnel on rank 0 while the other ranks replay; returns, per job, rank
    0's streams and config fences, and every rank's sampled ids."""
    import torch

    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import params_from_numpy
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

    out = {}
    for name, job in payload["jobs"].items():
        cfg = get_config(job.get("preset", "tiny"),
                         vocab_size=payload["vocab"])
        # tp = world unless the job sets its own mesh (tp x sp = world).
        ecfg = EngineConfig(**{"tp": world, **job["engine"]})
        dtype = torch.float32 if ecfg.dtype == "float32" else torch.bfloat16
        params = params_from_numpy(payload["weights"][job["weights"]], "cpu",
                                   dtype)
        engine = InferenceEngine(model_cfg=cfg, engine_cfg=ecfg, params=params,
                                 tokenizer=NumericTokenizer(payload["vocab"]),
                                 device="cpu")
        log = []
        _record(engine, log)
        res = {"ids": log}
        if rank == 0:
            async def drive():
                async with tunnel_stack(engine, engine_backend, run_serve,
                                        run_proxy, loopback_pair) as base:
                    return await conversations(base, job.get("max_tokens", 8))

            res["streams"] = asyncio.run(drive())
            res["fences"] = list(engine.config_fences)
            res["mesh"] = (engine.mesh.shape, engine.mesh.rank)
            res["sp_mode"] = engine.mcfg.sp_mode
            res["kv_shape"] = tuple(engine.kv_cache["k"].shape)
        else:
            res["ops"] = engine.spmd_follower_loop()
        out[name] = res
    return out


def warmup_gauges(rank, world, payload):
    """A ``tp = world`` engine per config of ``payload["configs"]`` (the
    tiny preset at ``payload["vocab"]``): rank 0 warms it up and returns,
    per config, the warmup gauges and its launch report; the other ranks
    replay rank 0's dispatches, the launch probe among them."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    out = {}
    for name, kw in payload["configs"].items():
        engine = InferenceEngine(
            model_cfg=get_config("tiny", vocab_size=payload["vocab"]),
            engine_cfg=EngineConfig(**{"num_slots": 4, "max_seq": 128,
                                       "tp": world, **kw}),
            tokenizer=NumericTokenizer(payload["vocab"]), device="cpu")
        if rank != 0:
            out[name] = engine.spmd_follower_loop()
            continue
        for gauge in GAUGES:
            global_metrics.set_gauge(gauge, 0.0)

        async def drive():
            await engine.start()
            try:
                await engine.warmup()
                report = await asyncio.get_running_loop().run_in_executor(
                    None, engine.decode_launch_report)
                return {"gauges": {g: global_metrics.gauge(g) for g in GAUGES},
                        "report": report}
            finally:
                await engine.stop()

        out[name] = asyncio.run(drive())
    return out


#: The gauges the engine's warmup publishes.
GAUGES = ("engine_decode_kernels_per_step", "engine_warmup_programs",
          "engine_warmup_compile_s", "engine_warmup_compile_max_s")


def engine_fences(rank, world, payload):
    """Construct a ``tp = world`` engine (or the config's own ``tp x sp``
    mesh) per config on every rank (their groups are created in the same
    order) and return rank 0's config fences; nothing is served."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from p2p_llm_tunnel_tpu_torch.models.config import get_config

    cfg = get_config("tiny", vocab_size=payload["vocab"])
    out = {}
    for name, kw in payload["configs"].items():
        engine = InferenceEngine(model_cfg=cfg,
                                 engine_cfg=EngineConfig(**{"tp": world, **kw}),
                                 device="cpu")
        out[name] = (list(engine.config_fences),
                     {k: getattr(engine.ecfg, k) for k in kw})
    return out


def coordinator_wire(rank, world, payload):
    """The control plane alone: rank 0 sends each payload op through a
    wrapped function; every rank records what the wrapped function was
    called with, and followers what ``recv`` returned."""
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh
    from p2p_llm_tunnel_tpu_torch.parallel.spmd_serve import SpmdCoordinator

    spmd = SpmdCoordinator.maybe(make_mesh(tp=world))
    seen = []

    def fn(carry, *host):
        seen.append((carry, host))
        return len(host)

    wrapped = spmd.wrap("op", fn, 1)
    got = []
    for args in payload:
        if rank == 0:
            wrapped(f"carry-{rank}", *args)
        else:
            op, host = spmd.recv()
            got.append((op, host))
            wrapped(f"carry-{rank}", *host)
    if rank == 0:
        spmd.send_stop()
    else:
        got.append(spmd.recv())
    return {"seen": seen, "got": got, "sent": spmd.ops_sent,
            "wrapped": (wrapped.op_name, wrapped.inner is fn)}


def cli_ranks(rank, world, flags):
    """``tunnel-gpu serve --backend gpu --device cpu --coordinator <this
    run's rendezvous> --process-id <rank> <flags>`` up to the engine
    backend: rank 0 generates a few tokens and stops; a follower's
    ``_engine_backend`` replays until then and returns None.  The run is
    already joined (``_entry``), so the CLI's join is the idempotent
    second call of ``init_distributed``."""
    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import ByteTokenizer

    # 260 ids divide over tp 2 (the byte tokenizer's 259 do not).
    cli._tokenizer = lambda spec: ByteTokenizer(260)
    args = cli.build_parser().parse_args(
        ["serve", "--backend", "gpu", "--device", "cpu", "--room", "r",
         "--coordinator", RENDEZVOUS, "--process-id", str(rank)] + flags)

    async def run():
        backend = await cli._engine_backend(args)
        if backend is None:
            return False, None
        engine = backend.kv_import.__self__
        try:
            out = [ev.token_id async for ev in engine.generate(
                list(b"coordinated"), max_new_tokens=5, stop_ids=())]
        finally:
            await engine.stop()
            cli._BACKEND = None
        return True, out

    ok, ids = asyncio.run(run())
    return {"backend": ok, "ids": ids, "ops": None,
            "ecfg": vars(cli._engine_config(args))}


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def several(rank, world, payload):
    """``(fn_name, payload)`` pairs of this module, run in order in one
    spawn of ranks; their results in order."""
    return [globals()[fn](rank, world, p) for fn, p in payload]


def _mesh_key(case):
    return tuple(case.get(a, 1) for a in ("tp", "sp", "ep", "dp"))


def _meshes(cases):
    """One joined mesh per distinct ``(tp, sp, ep, dp)`` of the cases, built
    in the cases' order on every rank (their groups are collective)."""
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh

    meshes = {}
    for case in cases:
        key = _mesh_key(case)
        if key not in meshes:
            meshes[key] = make_mesh(tp=key[0], sp=key[1], ep=key[2], dp=key[3])
    return meshes


def _block(x, mesh):
    """This rank's block of a global ``[B, T, H, D]`` array: sequence block
    ``sp_rank`` of axis 1 and head shard ``tp_rank`` of axis 2."""
    t, h = x.shape[1] // mesh.sp, x.shape[2] // mesh.tp
    return x[:, mesh.sp_rank * t:(mesh.sp_rank + 1) * t,
             mesh.tp_rank * h:(mesh.tp_rank + 1) * h].contiguous()


def sp_attention(rank, world, payload):
    """Each case runs ring or Ulysses attention on this rank's blocks of
    the global q/k/v under its ``(tp, sp)`` mesh; returns ``{case: this
    rank's output block (f32)}``."""
    import torch

    from p2p_llm_tunnel_tpu_torch.ops.ring_attention import ring_attention
    from p2p_llm_tunnel_tpu_torch.ops.ulysses_attention import ulysses_attention

    meshes = _meshes(payload.values())
    out = {}
    for name, case in payload.items():
        mesh = meshes[_mesh_key(case)]
        dtype = getattr(torch, case["dtype"])
        q, k, v = (_block(torch.from_numpy(case[n]).to(dtype), mesh) for n in "qkv")
        if case["mode"] == "ring":
            o = ring_attention(q, k, v, group=mesh.sp_group, softcap=case.get("softcap"))
        else:
            o = ulysses_attention(q, k, v, torch.from_numpy(case["valid"]),
                                  group=mesh.sp_group,
                                  softcap=case.get("softcap"), window=case.get("window"))
        out[name] = o.float().numpy()
    return out


def sp_exchanges(rank, world, payload):
    """Every exchange of ``parallel/collectives`` over an sp = world mesh, on
    this rank's input ``payload[rank]`` (f32, cast to each dtype); returns
    ``{(exchange, dtype): the result's bytes}``."""
    import torch

    from p2p_llm_tunnel_tpu_torch.parallel import collectives as col
    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh

    group = make_mesh(sp=world).sp_group
    out = {}
    for dtype in ("float32", "bfloat16"):
        x = torch.from_numpy(payload[rank]).to(getattr(torch, dtype))
        ops = {
            "ring_shift": lambda: col.ring_shift(x, group),
            "seq_to_heads": lambda: col.all_to_all(x, 2, 1, group),
            "heads_to_seq": lambda: col.all_to_all(x, 1, 2, group),
            "all_gather": lambda: col.all_gather(x, 1, group),
        }
        for op, fn in ops.items():
            y = fn()
            out[(op, dtype)] = (tuple(y.shape), y.contiguous().view(torch.uint8).numpy())
    return out


def sp_model(rank, world, payload):
    """Each case under its ``(tp, sp)`` mesh on JAX's weights (this rank's
    tp shard): ``prefill`` (whole-sequence logits and K/V) and
    ``prefill_into_cache`` (last logits and the cache this rank wrote)."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
        params_from_numpy_sharded,
        shard_kv_cache,
    )

    meshes = _meshes(payload.values())
    out = {}
    with torch.inference_mode():
        for name, case in payload.items():
            mesh = meshes[_mesh_key(case)]
            cfg = get_config(case["preset"], **case["overrides"])
            params = params_from_numpy_sharded(case["params"], cfg, mesh, "cpu",
                                               torch.float32)
            tokens = torch.from_numpy(case["tokens"])
            lengths = torch.from_numpy(case["lengths"])
            valid = torch.arange(tokens.shape[1])[None, :] < lengths[:, None]
            logits, ks, vs = tt.prefill(cfg, params, tokens, valid, mesh=mesh)
            cache = shard_kv_cache(tt.init_kv_cache(cfg, case["slots"], case["seq"],
                                                    torch.float32, device="cpu"),
                                   mesh)
            last, cache = tt.prefill_into_cache(
                cfg, params, tokens, lengths, cache,
                torch.from_numpy(case["slot_idx"]), mesh=mesh)
            out[name] = dict(logits=logits.numpy(), ks=ks.numpy(), vs=vs.numpy(),
                             last=last.numpy(), k=cache["k"].numpy(),
                             v=cache["v"].numpy())
    return out


# ---------------------------------------------------------------------------
# expert and data parallelism
# ---------------------------------------------------------------------------

def mesh_groups(rank, world, payload):
    """Each ``(dp, ep, tp, sp)`` shape of ``payload`` (product ``world``) as
    a joined mesh, in order: this rank's coordinates and the ranks of its
    group on each axis (None where the axis has size 1)."""
    import torch.distributed as dist

    from p2p_llm_tunnel_tpu_torch.parallel import make_mesh

    out = {}
    for dp, ep, tp, sp in payload:
        mesh = make_mesh(tp=tp, dp=dp, sp=sp, ep=ep)
        out[(dp, ep, tp, sp)] = {
            axis: (mesh.coord(axis), None if getattr(mesh, f"{axis}_group") is None
                   else dist.get_process_group_ranks(getattr(mesh, f"{axis}_group")))
            for axis in ("dp", "ep", "tp", "sp")}
    return out


def ep_model(rank, world, payload):
    """Each case under its ``(tp, ep)`` mesh on JAX's weights (this rank's
    shard): layer 0's ``moe_mlp`` on the case's hidden states and the
    whole-sequence ``prefill`` logits, with the expert leaves' local
    shapes."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import moe as tmoe
    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import params_from_numpy_sharded

    meshes = _meshes(payload.values())
    out = {}
    with torch.inference_mode():
        for name, case in payload.items():
            mesh = meshes[_mesh_key(case)]
            cfg = get_config(case["preset"], **case["overrides"])
            params = params_from_numpy_sharded(case["params"], cfg, mesh, "cpu",
                                               torch.float32)
            blk = {k: v[0] for k, v in params["blocks"].items()}
            mlp = tmoe.moe_mlp(cfg, blk, torch.from_numpy(case["h"]),
                               lambda x: tt._act(cfg, x), mesh)
            tokens = torch.from_numpy(case["tokens"])
            valid = torch.arange(tokens.shape[1])[None, :] < torch.from_numpy(
                case["lengths"])[:, None]
            logits, _, _ = tt.prefill(cfg, params, tokens, valid, mesh=mesh)
            out[name] = dict(mlp=mlp.numpy(), logits=logits.numpy(),
                             experts=tuple(params["blocks"]["moe_gate"].shape))
    return out


def dp_model(rank, world, payload):
    """Each case on a ``tp x dp = world`` mesh: one prefill wave and one
    decode step, the dp way (this rank runs the wave rows of its own slots
    into its cache block and decodes its block's rows) and, for the same
    tp group, the dp 1 way (the whole wave into a whole cache); returns
    this rank's rows, logits and cache bytes of both."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.data_parallel import SlotShard
    from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
        params_from_numpy_sharded,
        shard_kv_cache,
    )

    meshes = _meshes(payload.values())
    out = {}
    with torch.inference_mode():
        for name, case in payload.items():
            mesh = meshes[_mesh_key(case)]
            one = Mesh(tp=mesh.tp, rank=mesh.tp_rank, tp_group=mesh.tp_group)
            cfg = get_config(case["preset"], **case["overrides"])
            params = params_from_numpy_sharded(case["params"], cfg, mesh, "cpu",
                                               torch.float32)
            full = tt.init_kv_cache(cfg, case["slots"], case["seq"], torch.float32,
                                    quant=case.get("kv_quant"), device="cpu")
            local = shard_kv_cache({k: v.clone() for k, v in full.items()}, mesh)
            full = shard_kv_cache(full, one)
            tokens, lengths, slots = (torch.from_numpy(case[k])
                                      for k in ("tokens", "lengths", "slot_idx"))
            dec_tok, dec_pos = (torch.from_numpy(case[k])
                                for k in ("dec_tokens", "dec_pos"))
            last_ref, _ = tt.prefill_into_cache(cfg, params, tokens, lengths, full,
                                                slots, mesh=one)
            logits_ref, _ = tt.decode_step(cfg, params, full, dec_tok, dec_pos,
                                           mesh=one)
            shard = SlotShard(mesh, case["slots"], scratch=-1)
            idx = shard.route(case["slot_idx"])
            last, _ = tt.prefill_into_cache(
                cfg, params, tokens[idx], lengths[idx], local,
                torch.from_numpy(shard.local(case["slot_idx"][idx])), mesh=mesh)
            rows = slice(shard.lo, shard.hi)
            logits, _ = tt.decode_step(cfg, params, local, dec_tok[rows],
                                       dec_pos[rows], mesh=mesh)

            def raw(c):
                return {k: v.contiguous().view(torch.uint8).numpy().copy()
                        for k, v in c.items()}

            out[name] = dict(rows=(shard.lo, shard.hi), idx=idx,
                             last=last.numpy(), logits=logits.numpy(),
                             last_ref=last_ref.numpy(), logits_ref=logits_ref.numpy(),
                             cache=raw(local),
                             ref_rows=raw({k: v[:, rows] for k, v in full.items()}))
    return out


def dp_cli_streams(rank, world, payload):
    """Each job through the serve CLI's ``--coordinator <this run>
    --num-processes 2 --process-id <rank> --dp-dcn 2`` flags: the CLI's
    join gives the mesh and ``_engine_config`` the engine config; the
    engine serves the given weights, rank 0 the conversations through the
    port's tunnel while rank 1 replays.  Returns rank 0's streams and
    fences and every rank's mesh and cache rows."""
    import torch

    from p2p_llm_tunnel_tpu_torch import cli
    from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
    from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
    from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.models.transformer import params_from_numpy
    from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

    out = {}
    for name, flags in payload["jobs"].items():
        args = cli.build_parser().parse_args(
            ["serve", "--backend", "gpu", "--device", "cpu", "--room", "r",
             "--model", "tiny", "--dtype", "float32",
             "--coordinator", RENDEZVOUS, "--num-processes", str(world),
             "--process-id", str(rank)] + flags)
        ecfg = cli._engine_config(args)
        mesh, device = cli._join_ranks(args, None)
        try:
            engine = InferenceEngine(
                model_cfg=get_config("tiny", vocab_size=payload["vocab"]),
                engine_cfg=ecfg, params=params_from_numpy(payload["weights"], "cpu",
                                                          torch.float32),
                tokenizer=NumericTokenizer(payload["vocab"]), device=device,
                mesh=mesh)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        res = {"mesh": (engine.mesh.shape, engine.mesh.rank),
               "fences": list(engine.config_fences),
               "kv_rows": int(engine.kv_cache["k"].shape[1])}
        if name in payload.get("construct_only", ()):
            pass
        elif rank == 0:
            async def drive():
                async with tunnel_stack(engine, engine_backend, run_serve,
                                        run_proxy, loopback_pair) as base:
                    return await conversations(base, payload.get("max_tokens", 8))

            res["streams"] = asyncio.run(drive())
        else:
            res["ops"] = engine.spmd_follower_loop()
        out[name] = res
        del engine
    return out



# ---------------------------------------------------------------------------
# training: the dp x tp (x ep) step, the pipeline, the collectives' backward
# ---------------------------------------------------------------------------

def _tree(tree, fn):
    """``fn`` of every leaf of a params tree, as a tree of the same keys."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _numpy(tree, fn=lambda x: x):
    return _tree(tree, lambda x: fn(x).detach().numpy().copy())


def train_model(rank, world, payload):
    """Each case under its ``(tp, ep, dp)`` mesh on JAX's fp32 weights (this
    rank's shard): ``make_train_step``'s ``steps`` steps on the case's whole
    batch; returns every step's loss, and after the first the gradients,
    the parameters and the shapes of both AdamW moments (this rank's
    shard), and the leaf shapes ``init_fn`` draws."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.sharding import params_from_numpy_sharded
    from p2p_llm_tunnel_tpu_torch.parallel.train import (
        make_optimizer,
        make_train_step,
        param_leaves,
    )

    meshes = _meshes(payload.values())
    out = {}
    for name, case in payload.items():
        mesh = meshes[_mesh_key(case)]
        cfg = get_config(case["preset"], **case["overrides"])
        init_fn, step_fn = make_train_step(cfg, mesh, lr=case["lr"], device="cpu")
        drawn, _ = init_fn(0)
        params = params_from_numpy_sharded(case["params"], cfg, mesh, "cpu",
                                           torch.float32)
        for leaf in param_leaves(params):
            leaf.requires_grad_(True)
        opt = make_optimizer(params, case["lr"])
        batch = [torch.from_numpy(case[k]) for k in ("tokens", "targets", "valid")]
        res = dict(losses=[], init_shapes=_tree(drawn, lambda x: tuple(x.shape)))
        for step in range(case["steps"]):
            params, opt, loss = step_fn(params, opt, *batch)
            res["losses"].append(float(loss))
            if step == 0:
                res.update(
                    grads=_numpy(params, lambda x: x.grad),
                    params=_numpy(params),
                    moments=_tree(params, lambda x: tuple(
                        tuple(opt.state[x][m].shape) for m in ("exp_avg", "exp_avg_sq"))))
        out[name] = res
    return out


def pipeline_model(rank, world, payload):
    """Each case on a ``pp = world`` pipeline mesh, this rank one stage of
    JAX's fp32 weights: ``pipeline_prefill``'s logits and, where the case
    has targets, ``pipeline_loss_fn``'s loss and this stage's gradients."""
    import torch

    from p2p_llm_tunnel_tpu_torch.models import transformer as tt
    from p2p_llm_tunnel_tpu_torch.models.config import get_config
    from p2p_llm_tunnel_tpu_torch.parallel.pipeline import (
        make_pp_mesh,
        pipeline_loss_fn,
        pipeline_prefill,
        shard_params_pp,
    )
    from p2p_llm_tunnel_tpu_torch.parallel.train import param_leaves

    mesh = make_pp_mesh(world)
    out = {}
    for name, case in payload.items():
        cfg = get_config(case["preset"])
        stage = shard_params_pp(tt.params_from_numpy(case["params"], "cpu",
                                                     torch.float32), mesh)
        tokens = torch.from_numpy(case["tokens"])
        valid = torch.from_numpy(case["valid"])
        with torch.no_grad():
            logits = pipeline_prefill(cfg, stage, tokens, valid, mesh, case["n_micro"])
        res = dict(logits=logits.numpy(),
                   layers=tuple(stage["blocks"]["wq"].shape))
        if "targets" in case:
            for leaf in param_leaves(stage):
                leaf.requires_grad_(True)
            loss = pipeline_loss_fn(cfg, stage, tokens, torch.from_numpy(case["targets"]),
                                    valid, mesh, case["n_micro"])
            loss.backward()
            res.update(loss=float(loss), grads=_numpy(stage, lambda x: x.grad))
        out[name] = res
    return out


def collective_grads(rank, world, payload):
    """Each differentiable exchange of ``parallel/collectives`` over the
    world on this rank's ``payload["x"][rank]``, pulled back with this
    rank's cotangent ``payload["dy"][rank]``: ``{op: (forward under grad,
    forward without grad, the input's gradient)}``."""
    import torch

    from p2p_llm_tunnel_tpu_torch.parallel import collectives as col

    group = torch.distributed.group.WORLD
    ops = {
        "all_reduce_sum": lambda x: col.all_reduce_sum(x, group),
        "copy_to_group": lambda x: col.copy_to_group(x, group),
        "all_gather": lambda x: col.all_gather(x, 1, group),
        "ring_shift": lambda x: col.ring_shift(x, group),
    }
    out = {}
    for op, fn in ops.items():
        x = torch.from_numpy(payload["x"][rank]).requires_grad_(True)
        y = fn(x)
        dy = torch.from_numpy(payload["dy"][op][rank])
        y.backward(dy)
        with torch.no_grad():
            plain = fn(x.detach().clone())
        out[op] = (y.detach().numpy().copy(), plain.numpy().copy(),
                   x.grad.numpy().copy())
    return out
