"""The port's ``tunnel-gpu`` CLI: serve flags map onto the engine config
with the JAX serve CLI's defaults (``--ep`` and ``--dp-dcn`` included,
with the rank count a ``--coordinator`` run must have), and ``serve
--backend gpu --device cpu``
brings up a working engine backend (on the CPU, as the tests run) — also
at ``--tp 2``, where this process is rank 0 and starts rank 1 itself, and
with ``--coordinator``, where every rank runs the CLI (two spawned gloo
ranks, ``torch_tp_ranks``)."""

import argparse
import asyncio

import pytest
import torch

from p2p_llm_tunnel_tpu import cli as j_cli
from p2p_llm_tunnel_tpu_torch import cli

SERVE = ["serve", "--backend", "gpu", "--model", "tiny", "--slots", "4",
         "--max-seq", "128", "--dtype", "float32", "--device", "cpu",
         "--room", "r"]


def test_serve_flags_map_onto_engine_config():
    args = cli.build_parser().parse_args(SERVE + ["--decode-steps", "6",
                                                  "--max-waiting", "9"])
    ecfg = cli._engine_config(args)
    assert (ecfg.model, ecfg.num_slots, ecfg.max_seq, ecfg.dtype) == (
        "tiny", 4, 128, "float32")
    assert (ecfg.decode_steps, ecfg.max_waiting) == (6, 9)
    # The JAX serve CLI's defaults: mux, prefix cache and conversation
    # cache ON, ragged prefill off.
    assert ecfg.mux and ecfg.prefix_cache and ecfg.conv_cache
    assert not ecfg.ragged_prefill


ENGINE_DEFAULTS = ("mux", "prefix_cache", "conv_cache", "ragged_prefill",
                   "prefill_chunk", "mux_budget_tokens", "prefix_pool_blocks",
                   "prefix_evict")


@pytest.mark.parametrize("extra", [[], ["--no-mux"], ["--no-prefix-cache"],
                                   ["--no-conv-cache"], ["--ragged-prefill"],
                                   ["--prefill-chunk", "64",
                                    "--mux-budget-tokens", "256",
                                    "--prefix-pool-blocks", "32",
                                    "--prefix-evict", "lru"]])
def test_serve_engine_defaults_equal_the_jax_cli(extra, monkeypatch):
    """``tunnel-gpu serve --backend gpu`` builds the same engine knobs as
    ``tunnel serve --backend tpu`` from the same flags and environment."""
    for var in ("TUNNEL_MUX", "TUNNEL_PREFIX_CACHE", "TUNNEL_CONV_CACHE",
                "TUNNEL_RAGGED_PREFILL", "TUNNEL_PREFILL_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    args = cli.build_parser().parse_args(SERVE + extra)
    jargs = j_cli.build_parser().parse_args(
        ["serve", "--backend", "tpu", "--room", "r"] + extra)
    ecfg = cli._engine_config(args)
    want = dict(
        mux=jargs.mux, prefix_cache=jargs.prefix_cache,
        conv_cache=jargs.conv_cache and jargs.prefix_cache,
        ragged_prefill=jargs.ragged_prefill, prefill_chunk=jargs.prefill_chunk,
        mux_budget_tokens=jargs.mux_budget_tokens,
        prefix_pool_blocks=jargs.prefix_pool_blocks,
        prefix_evict=jargs.prefix_evict)
    assert {k: getattr(ecfg, k) for k in ENGINE_DEFAULTS} == want


def test_env_names_match_the_jax_cli(monkeypatch):
    monkeypatch.setenv("TUNNEL_MUX", "0")
    monkeypatch.setenv("TUNNEL_CONV_CACHE", "0")
    monkeypatch.setenv("TUNNEL_RAGGED_PREFILL", "1")
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE))
    assert (ecfg.mux, ecfg.prefix_cache, ecfg.conv_cache,
            ecfg.ragged_prefill) == (False, True, False, True)


@pytest.mark.parametrize("flag,env,field,value", [
    ("--prefix-cache-dir", "TUNNEL_PREFIX_CACHE_DIR", "prefix_cache_dir", "/x"),
    ("--spill-pages", "TUNNEL_SPILL_PAGES", "spill_pages", "4"),
    ("--role", "TUNNEL_ROLE", "role", "prefill"),
])
def test_spill_snapshot_and_role_flags_reach_the_engine_config(
        flag, env, field, value, monkeypatch):
    """``--spill-pages``, ``--prefix-cache-dir`` and ``--role`` (once
    refused) map onto the EngineConfig with the JAX serve CLI's default,
    environment variable and value."""
    monkeypatch.delenv(env, raising=False)
    jserve = ["serve", "--backend", "tpu", "--room", "r"]

    def both(extra):
        ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE + extra))
        jargs = j_cli.build_parser().parse_args(jserve + extra)
        return getattr(ecfg, field), getattr(jargs, field)

    got, want = both([])
    assert got == want == {"prefix_cache_dir": None, "spill_pages": 0,
                           "role": "both"}[field]
    got, want = both([flag, value])
    assert got == want and str(got) == value
    monkeypatch.setenv(env, value)
    got, want = both([])
    assert got == want and str(got) == value


@pytest.mark.parametrize("extra,item", [
    (["--ep", "2"], "18c"),
    (["--sp", "2"], "18b"),
    (["--sp", "2", "--sp-mode", "ulysses"], "18b"),
    (["--dp-dcn", "2"], "18d"),
])
def test_sp_ep_dp_flags_reach_the_engine_config(extra, item):
    """Items 18b, 18c and 18d are ported: --sp, --sp-mode, --ep and
    --dp-dcn reach the engine config (and the mesh flags) as in the JAX
    CLI, and a --coordinator run must count every rank of the mesh they
    make."""
    args = cli.build_parser().parse_args(SERVE + extra)
    jargs = j_cli.build_parser().parse_args(
        ["serve", "--backend", "tpu", "--room", "r"] + extra)
    ecfg = cli._engine_config(args)
    assert (ecfg.sp, ecfg.sp_mode, ecfg.ep) == (jargs.sp, jargs.sp_mode, jargs.ep)
    assert args.dp_dcn == jargs.dp_dcn
    assert ecfg.sp * ecfg.ep * args.dp_dcn == 2
    bad = cli.build_parser().parse_args(
        SERVE + extra + ["--coordinator", "h:1", "--num-processes", "1",
                         "--process-id", "0"])
    with pytest.raises(SystemExit, match="must equal --tp 1 x --sp"):
        cli._engine_config(bad)
    ok = cli.build_parser().parse_args(
        SERVE + extra + ["--coordinator", "h:1", "--num-processes", "2",
                         "--process-id", "0"])
    assert cli._engine_config(ok) == ecfg


def test_ckpt_flag_reaches_the_engine_config(monkeypatch):
    """``--ckpt`` and its ``TUNNEL_CKPT`` environment default map onto
    ``EngineConfig.ckpt_path`` as the JAX CLI's do.  A stated divergence:
    the port's ``--ckpt`` reads a ``models.checkpoint.save_checkpoint``
    directory, not a JAX orbax one (the help says so)."""
    monkeypatch.delenv("TUNNEL_CKPT", raising=False)
    assert cli._engine_config(cli.build_parser().parse_args(SERVE)).ckpt_path is None
    flags = ["--ckpt", "/ckpt/llama"]
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE + flags))
    jargs = j_cli.build_parser().parse_args(["serve", "--backend", "tpu", "--room",
                                             "r"] + flags)
    assert ecfg.ckpt_path == jargs.ckpt == "/ckpt/llama"
    monkeypatch.setenv("TUNNEL_CKPT", "/ckpt/env")
    assert cli._engine_config(cli.build_parser().parse_args(SERVE)).ckpt_path == "/ckpt/env"
    serve = next(a for a in cli.build_parser()._actions
                 if isinstance(a, argparse._SubParsersAction)).choices["serve"]
    help_text = next(a.help for a in serve._actions if "--ckpt" in a.option_strings)
    assert "save_checkpoint" in help_text and "orbax" in help_text


def test_spec_flags_reach_the_engine_config(monkeypatch):
    """``--spec-ngram/--spec-k/--spec-k-max`` and their ``TUNNEL_SPEC_*``
    environment names map onto the engine config as the JAX CLI's do."""
    for var in ("TUNNEL_SPEC_NGRAM", "TUNNEL_SPEC_K", "TUNNEL_SPEC_K_MAX"):
        monkeypatch.delenv(var, raising=False)
    args = cli.build_parser().parse_args(SERVE)
    ecfg = cli._engine_config(args)
    assert (ecfg.spec_ngram, ecfg.spec_k, ecfg.spec_k_max) == (0, 4, 0)
    flags = ["--spec-ngram", "3", "--spec-k", "4", "--spec-k-max", "8"]
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE + flags))
    jargs = j_cli.build_parser().parse_args(
        ["serve", "--backend", "tpu", "--room", "r"] + flags)
    assert (ecfg.spec_ngram, ecfg.spec_k, ecfg.spec_k_max) == (
        jargs.spec_ngram, jargs.spec_k, jargs.spec_k_max) == (3, 4, 8)
    monkeypatch.setenv("TUNNEL_SPEC_NGRAM", "2")
    monkeypatch.setenv("TUNNEL_SPEC_K", "3")
    monkeypatch.setenv("TUNNEL_SPEC_K_MAX", "6")
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE))
    assert (ecfg.spec_ngram, ecfg.spec_k, ecfg.spec_k_max) == (2, 3, 6)


@pytest.mark.parametrize("mux", [["--mux"], ["--no-mux"]])
@pytest.mark.parametrize("fused", [[], ["--fused-decode-layer"]])
@pytest.mark.parametrize("kv", ["none", "int8", "int4"])
def test_spec_builds_an_engine_on_every_combination(kv, fused, mux):
    """``serve --spec-ngram 3`` builds an engine on every KV form, fused or
    not, mux or not; no combination is fenced."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine

    args = cli.build_parser().parse_args(
        SERVE + ["--kv-quant", kv, "--spec-ngram", "3", "--spec-k-max", "8"]
        + fused + mux)
    engine = InferenceEngine(engine_cfg=cli._engine_config(args), device="cpu")
    assert engine.config_fences == []
    assert engine.ecfg.spec_ngram == 3
    assert engine.mcfg.fused_decode_layer == bool(fused)


def test_quantized_fused_flags_build_an_engine(monkeypatch):
    """``--kv-quant int4 --fused-decode-layer --ragged-prefill`` builds an
    unfenced engine that serves; the env names are the JAX CLI's."""
    args = cli.build_parser().parse_args(
        SERVE + ["--kv-quant", "int4", "--fused-decode-layer", "--ragged-prefill"])
    ecfg = cli._engine_config(args)
    assert (ecfg.kv_quant, ecfg.fused_decode_layer, ecfg.ragged_prefill) == (
        "int4", True, True)

    async def run():
        backend = await cli._engine_backend(args)
        engine = backend.kv_import.__self__
        try:
            assert engine.config_fences == []
            assert engine.mcfg.fused_decode_layer
            assert engine.kv_cache["k"].dtype == torch.int8
            events = [ev async for ev in engine.generate(
                list(b"hello"), max_new_tokens=3)]
            return [ev.token_id for ev in events]
        finally:
            await engine.stop()
            cli._BACKEND = None

    assert len(asyncio.run(run())) == 3
    monkeypatch.setenv("TUNNEL_KV_QUANT", "int8")
    monkeypatch.setenv("TUNNEL_FUSED_DECODE", "1")
    args = cli.build_parser().parse_args(SERVE)
    jargs = j_cli.build_parser().parse_args(["serve", "--backend", "tpu", "--room", "r"])
    assert (args.kv_quant, args.fused_decode_layer) == (
        jargs.kv_quant, jargs.fused_decode_layer) == ("int8", True)


def test_engine_backend_on_cpu_serves_a_request():
    args = cli.build_parser().parse_args(SERVE)

    async def run():
        backend = await cli._engine_backend(args)
        engine = backend.kv_import.__self__
        try:
            assert engine.device.type == "cpu"
            events = [ev async for ev in engine.generate(
                list(b"hello"), max_new_tokens=3)]
            return [ev.token_id for ev in events]
        finally:
            await engine.stop()
            cli._BACKEND = None

    assert len(asyncio.run(run())) == 3


# ---------------------------------------------------------------------------
# parallel flags: --tp, --replicas, --coordinator, --num-processes,
# --process-id, --dp-dcn (and the JAX command line's --flash-* flags)
# ---------------------------------------------------------------------------

PARALLEL_ENV = [
    ("TUNNEL_TP", "tp", "2"),
    ("TUNNEL_SP", "sp", "2"),
    ("TUNNEL_SP_MODE", "sp_mode", "ulysses"),
    ("TUNNEL_EP", "ep", "2"),
    ("TUNNEL_REPLICAS", "replicas", "3"),
    ("TUNNEL_COORDINATOR", "coordinator", "host0:8476"),
    ("MEGASCALE_COORDINATOR_ADDRESS", "coordinator", "host1:8476"),
    ("TUNNEL_NUM_PROCESSES", "num_processes", "4"),
    ("TUNNEL_PROCESS_ID", "process_id", "1"),
    ("TUNNEL_DP_DCN", "dp_dcn", "2"),
    ("TUNNEL_FLASH_DECODE", "flash_decode", "1"),
    ("TUNNEL_FLASH_SGRID", "flash_sgrid", "1"),
]


@pytest.mark.parametrize("env,field,value", PARALLEL_ENV)
def test_parallel_flags_and_env_names_match_the_jax_cli(env, field, value,
                                                       monkeypatch):
    """Each flag's default and env name are the JAX serve CLI's."""
    for var, _, _ in PARALLEL_ENV:
        monkeypatch.delenv(var, raising=False)

    def both():
        got = getattr(cli.build_parser().parse_args(SERVE), field)
        want = getattr(j_cli.build_parser().parse_args(
            ["serve", "--backend", "tpu", "--room", "r"]), field)
        return got, want

    default, want = both()
    assert default == want
    monkeypatch.setenv(env, value)
    got, want = both()
    assert got == want != default


def test_jax_command_line_with_flash_flags_parses():
    """``--flash-decode`` / ``--flash-sgrid`` (and their negations) parse as
    in the JAX CLI and reach the engine config, where they choose nothing
    on the card."""
    for extra, want in ((["--flash-decode", "--flash-sgrid"], (True, True)),
                        (["--no-flash-decode", "--no-flash-sgrid"], (False, False))):
        args = cli.build_parser().parse_args(SERVE + extra)
        jargs = j_cli.build_parser().parse_args(
            ["serve", "--backend", "tpu", "--room", "r"] + extra)
        ecfg = cli._engine_config(args)
        assert (ecfg.flash_decode, ecfg.flash_sgrid) == want == (
            jargs.flash_decode, jargs.flash_sgrid)


def test_tp_reaches_the_engine_config():
    args = cli.build_parser().parse_args(SERVE + ["--tp", "2"])
    assert cli._engine_config(args).tp == 2


def test_cli_rejects_partial_multihost_flags():
    """--coordinator without rank info fails loudly (the JAX CLI's error),
    not an independent single-host server for every rank."""
    args = cli.build_parser().parse_args(SERVE + ["--coordinator", "host0:8476"])
    with pytest.raises(SystemExit, match="num-processes"):
        asyncio.run(cli._engine_backend(args))


@pytest.mark.parametrize("extra,match", [
    (["--replicas", "2", "--coordinator", "host0:8476", "--num-processes", "2",
      "--process-id", "0", "--tp", "2"], "single-host data-parallel mode"),
    (["--replicas", "2", "--tp", "2"], "rank group of its own"),
    (["--coordinator", "host0:8476", "--num-processes", "4", "--process-id", "0",
      "--tp", "2"], "must equal --tp 2"),
    (["--coordinator", "host0:8476", "--num-processes", "2", "--process-id", "0",
      "--tp", "2", "--sp", "2"], "must equal --tp 2 x --sp 2 = 4"),
    (["--replicas", "2", "--sp", "2"], "rank group of its own"),
])
def test_parallel_flag_sets_the_port_refuses(extra, match):
    args = cli.build_parser().parse_args(SERVE + extra)
    with pytest.raises(SystemExit, match=match):
        cli._engine_config(args)


def test_tp_sp_on_one_host_starts_tp_times_sp_ranks(monkeypatch):
    """``serve --tp 2 --sp 2`` with no --coordinator: rank 0 starts ranks
    1..3 of a world of 4 with the engine config it builds itself, and
    joins a 2 x 2 mesh (the joins are recorded, not made)."""
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    seen = {}
    monkeypatch.setattr(pd, "build_before_launch", lambda device: None)
    monkeypatch.setattr(pd, "launch_local_followers", lambda n, make_spec: seen.update(
        n=n, specs=[make_spec(r) for r in range(1, n)]) or "followers")
    monkeypatch.setattr(pd, "init_distributed", lambda *a, **kw: seen.update(join=a))
    monkeypatch.setattr(pd, "make_mesh", lambda **kw: kw)
    monkeypatch.setattr(cli, "_FOLLOWERS", None)
    args = cli.build_parser().parse_args(SERVE + ["--tp", "2", "--sp", "2"])
    mesh, _ = cli._join_ranks(args, None)
    assert mesh == {"tp": 2, "sp": 2, "ep": 1} and seen["n"] == 4
    assert [(s.rank, s.world) for s in seen["specs"]] == [(1, 4), (2, 4), (3, 4)]
    assert all((s.engine_cfg.tp, s.engine_cfg.sp) == (2, 2) for s in seen["specs"])
    assert seen["join"][1:3] == (4, 0) and cli._FOLLOWERS == "followers"


def test_serve_tp2_starts_its_follower_rank(tmp_path, monkeypatch):
    """``serve --tp 2`` with no --coordinator (the JAX single-host command
    line): this process becomes rank 0, starts rank 1 as a local process,
    serves a request whose greedy ids equal a one-process engine's on the
    same seed-0 weights, and releases rank 1 at stop."""
    from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd

    from p2p_llm_tunnel_tpu_torch.engine.tokenizer import ByteTokenizer

    monkeypatch.setattr(pd, "local_rendezvous",
                        lambda: f"file://{tmp_path}/rendezvous")
    # The spawned rank inherits the environment: one compute thread, as
    # the test workers share the machine.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # The byte tokenizer's 259 ids do not divide over tp 2 (the vocab axis
    # is sharded; JAX's device_put refuses it too): widen it to 260.
    monkeypatch.setattr(cli, "_tokenizer", lambda spec: ByteTokenizer(260))
    tiny = ["--model", "tiny", "--slots", "2", "--max-seq", "128", "--dtype",
            "float32", "--device", "cpu"]

    async def ids(args):
        backend = await cli._engine_backend(args)
        engine = backend.kv_import.__self__
        try:
            out = [ev.token_id async for ev in engine.generate(
                list(b"hello tensor parallel"), max_new_tokens=6, stop_ids=())]
            return out, engine
        finally:
            await engine.stop()
            cli._BACKEND = None

    try:
        got, engine = asyncio.run(asyncio.wait_for(ids(cli.build_parser().parse_args(
            ["serve", "--backend", "gpu", "--room", "r", "--tp", "2"] + tiny)), 120))
        followers = cli._FOLLOWERS
        assert engine.mesh.tp == 2 and engine._spmd.rank == 0
        assert len(followers.procs) == 1
        followers.close(timeout_s=30.0)
        assert not followers.alive() and followers.failed() == []
    finally:
        pd.shutdown_distributed()
        if cli._FOLLOWERS is not None:
            cli._FOLLOWERS.close(timeout_s=5.0)
            cli._FOLLOWERS = None
    want, _ = asyncio.run(ids(cli.build_parser().parse_args(
        ["serve", "--backend", "gpu", "--room", "r"] + tiny)))
    assert got == want and len(got) == 6


def test_coordinator_ranks_build_the_engine_the_jax_cli_builds(tmp_path):
    """``serve --coordinator ... --num-processes 2 --process-id r --tp 2``
    on two ranks: each builds the engine config the JAX CLI builds from
    the same flags; rank 1 replays and opens no tunnel, rank 0 serves."""
    from torch_tp_ranks import run_ranks

    flags = ["--model", "tiny-gemma", "--slots", "2", "--max-seq", "128",
             "--dtype", "float32", "--tp", "2", "--num-processes", "2"]
    lead, follower = run_ranks("cli_ranks", 2, flags, tmp_path)
    jargs = j_cli.build_parser().parse_args(
        ["serve", "--backend", "tpu", "--room", "r", "--coordinator", "h:1",
         "--process-id", "0"] + flags)
    for rank in (lead, follower):
        assert rank["ecfg"]["tp"] == jargs.tp == 2
        assert (rank["ecfg"]["mux"], rank["ecfg"]["prefix_cache"]) == (
            jargs.mux, jargs.prefix_cache)
    assert lead["backend"] and not follower["backend"]
    assert len(lead["ids"]) == 5 and follower["ops"] is None


# ---------------------------------------------------------------------------
# relay / signal
# ---------------------------------------------------------------------------

def _subparser(parser: argparse.ArgumentParser, name: str) -> argparse.ArgumentParser:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["relay", "signal"])
def test_relay_and_signal_flags_equal_the_jax_cli(command, monkeypatch):
    for env in ("TUNNEL_RELAY_SECRET", "TUNNEL_STUN_PORT"):
        monkeypatch.delenv(env, raising=False)
    want = _flags(_subparser(j_cli.build_parser(), command))
    assert _flags(_subparser(cli.build_parser(), command)) == want
    # The env defaults are read when the parser is built, as in the JAX CLI.
    env, dest, value = {"relay": ("TUNNEL_RELAY_SECRET", "secret", "s3cret"),
                        "signal": ("TUNNEL_STUN_PORT", "stun_port", 3478)}[command]
    monkeypatch.setenv(env, str(value))
    got = cli.build_parser().parse_args([command])
    jgot = j_cli.build_parser().parse_args([command])
    assert getattr(got, dest) == getattr(jgot, dest) == value


def test_relay_dispatches_to_the_ports_relay_server(monkeypatch):
    from p2p_llm_tunnel_tpu_torch.transport import relay

    calls = []

    async def fake(host, port, secret):
        calls.append((host, port, secret))

    monkeypatch.setattr(relay, "run_relay_server", fake)
    args = cli.build_parser().parse_args(
        ["relay", "--listen", "127.0.0.1", "--port", "4000", "--secret", "k"])
    asyncio.run(cli._amain(args))  # no --room needed, no engine built
    assert calls == [("127.0.0.1", 4000, "k")]
    asyncio.run(cli._amain(cli.build_parser().parse_args(["relay"])))
    assert calls[-1] == ("0.0.0.0", 3479, None)


def test_relay_started_by_the_cli_pairs_two_sessions():
    """Two channels that never exchange direct candidates talk through a
    relay that ``tunnel-gpu relay`` started (tests/test_nat_traversal.py's
    pairing case on the port's relay, channels and handshake)."""
    import socket

    pytest.importorskip("cryptography")
    from p2p_llm_tunnel_tpu_torch.transport.crypto import HandshakeKeys
    from p2p_llm_tunnel_tpu_torch.transport.udp import UdpChannel

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    ka, kb = HandshakeKeys(), HandshakeKeys()
    box_a = ka.derive(kb.public_bytes, offerer=True, room="relay-room")
    box_b = kb.derive(ka.public_bytes, offerer=False, room="relay-room")

    async def run():
        args = cli.build_parser().parse_args(
            ["relay", "--listen", "127.0.0.1", "--port", str(port)])
        server = asyncio.create_task(cli._amain(args))
        await asyncio.sleep(0.2)
        assert not server.done()
        relay_addr = ("127.0.0.1", port)
        a = await UdpChannel.bind("127.0.0.1")
        b = await UdpChannel.bind("127.0.0.1")
        try:
            a.set_session(box_a)
            b.set_session(box_b)
            await asyncio.gather(a.join_relay(relay_addr, "tok123"),
                                 b.join_relay(relay_addr, "tok123"))
            await asyncio.gather(a.punch([relay_addr], timeout=5.0),
                                 b.punch([relay_addr], timeout=5.0))
            await a.send(b"hello through the relay")
            assert await asyncio.wait_for(b.recv(), 5.0) == b"hello through the relay"
            await b.send(b"and back")
            assert await asyncio.wait_for(a.recv(), 5.0) == b"and back"
        finally:
            a.close()
            b.close()
            server.cancel()
            await asyncio.gather(server, return_exceptions=True)

    asyncio.run(run())
