"""The port's ``tunnel-gpu`` CLI: serve flags map onto the engine config
with the JAX serve CLI's defaults, flags of features the port does not
run yet (``parallel/``) are rejected with their ROADMAP.md port-queue
item, and ``serve --backend gpu --device cpu`` brings up a working engine
backend (on the CPU, as the tests run)."""

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
    (["--ep", "2"], "parallel/"),
    (["--sp", "2"], "parallel/"),
    (["--tp", "2"], "parallel/"),
    (["--replicas", "2"], "parallel/"),
    (["--coordinator", "localhost:1234"], "parallel/"),
])
def test_unported_flags_exit_with_their_queue_item(extra, item):
    args = cli.build_parser().parse_args(SERVE + extra)
    with pytest.raises(SystemExit) as exc:
        cli._engine_config(args)
    assert "ROADMAP.md" in str(exc.value) and item in str(exc.value)


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
