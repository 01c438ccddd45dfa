"""The port's ``tunnel-gpu`` CLI: serve flags map onto the engine config,
flags of features this slice does not port are rejected with their
ROADMAP.md port-queue item, and ``serve --backend gpu --device cpu``
brings up a working engine backend (on the CPU, as the tests run)."""

import asyncio

import pytest

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
    # The JAX serve CLI defaults these ON; the port keeps them off until
    # they are ported.
    assert not (ecfg.mux or ecfg.prefix_cache or ecfg.conv_cache)


@pytest.mark.parametrize("extra,item", [
    (["--mux"], "mux + prefix pool"),
    (["--prefix-cache"], "mux + prefix pool"),
    (["--kv-quant", "int8"], "quantized weights and KV"),
    (["--quant", "int4"], "quantized weights and KV"),
    (["--fused-decode-layer"], "fused decode layer"),
    (["--spec-ngram", "3"], "spec decode"),
    (["--tp", "2"], "parallel/"),
    (["--replicas", "2"], "parallel/"),
])
def test_unported_flags_exit_with_their_queue_item(extra, item):
    args = cli.build_parser().parse_args(SERVE + extra)
    with pytest.raises(SystemExit) as exc:
        cli._engine_config(args)
    assert "ROADMAP.md" in str(exc.value) and item in str(exc.value)


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
