"""The port's decode launch reports and warmup gauges, on the CPU.

``InferenceEngine.decode_launch_report`` / ``spec_launch_report`` count
one parked burst with ``utils/launch_count.LaunchCount``: every
hand-written kernel wrapper is one launch on either device, so these
numbers are the card's too (``chip_smoke.py`` phase 15c holds the card's
report to the CPU's).  Pinned here: the keys, one kernel per layer-step
on the fused and the kernel-2 paths, the fused path's cut of the layer
body at the reference's thresholds (``tests/test_fused_decode_layer.py``:
>= 40% with a quantized cache, >= 30% with a raw one), the gauges warmup
publishes (the twin of ``tests/test_flight.py``'s warmup-gauge test),
``/healthz``'s ``decode_kernels_per_step``, and rank 0 of a tp 2 engine
finishing warmup with its gauge set.
"""

import asyncio
import contextlib
import json

import pytest

from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics
from torch_tp_ranks import GAUGES, run_ranks

KEYS = {"total_ops", "total_major", "total_kernels",
        "layer_body_ops", "layer_body_major", "layer_body_kernels"}

#: The reference's launch-count config (test_fused_decode_layer.TILE_CFG),
#: served with int4 weights in groups of 64 as there.
TILE_CFG = ModelConfig(
    name="tiny128", vocab_size=256, dim=128, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=128, ffn_dim=256,
)


def _engine(model_cfg=None, **kw) -> InferenceEngine:
    return InferenceEngine(
        model_cfg=model_cfg,
        engine_cfg=EngineConfig(**{"model": "tiny", "num_slots": 3,
                                   "max_seq": 256, **kw}),
        device="cpu")


def _reports(engine, spec: bool = False):
    """(decode report, spec report or None) of a started engine."""
    async def main():
        await engine.start()
        try:
            loop = asyncio.get_running_loop()
            dec = await loop.run_in_executor(None, engine.decode_launch_report)
            sp = (await loop.run_in_executor(None, engine.spec_launch_report)
                  if spec else None)
            return dec, sp
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_reports_count_one_kernel_per_layer_step(kv_quant, fused):
    engine = _engine(kv_quant=kv_quant, fused_decode_layer=fused,
                     spec_ngram=3, decode_steps=4)
    dec, spec = _reports(engine, spec=True)
    n = engine.mcfg.n_layers
    for report in (dec, spec):
        assert set(report) == KEYS
        assert 1 <= report["layer_body_major"] < report["layer_body_ops"]
        assert report["total_major"] < report["total_ops"]
    # Kernel 2 or kernel 4 once a layer, every step of the burst.
    assert dec["layer_body_kernels"] == 1
    assert dec["total_kernels"] == n * 4
    assert dec["total_ops"] >= 4 * n * dec["layer_body_ops"]
    # A verify burst is one model call: kernel 5 once a layer when fused;
    # unfused it runs the chunk path, whose attention is einsum, as in the
    # reference.
    assert spec["layer_body_kernels"] == int(fused)
    assert spec["total_kernels"] == n * int(fused)


def test_report_takes_the_burst_width_and_view():
    engine = _engine(decode_steps=4)
    async def main():
        await engine.start()
        try:
            loop = asyncio.get_running_loop()
            return [await loop.run_in_executor(
                None, lambda s=s: engine.decode_launch_report(view=128, steps=s))
                for s in (1, 2)]
        finally:
            await engine.stop()

    one, two = asyncio.run(main())
    assert two["layer_body_ops"] == one["layer_body_ops"]
    assert two["total_kernels"] == 2 * one["total_kernels"]
    assert two["total_ops"] == 2 * one["total_ops"]


@pytest.mark.parametrize("kv_quant,cut", [("int8", 0.40), ("int4", 0.40),
                                          ("none", 0.30)])
def test_fused_path_cuts_the_layer_body(kv_quant, cut):
    """The reference's acceptance thresholds on the port's counts: int4
    weights (kernel 7 per product) and the cache in ``kv_quant``."""
    base = dict(quant="int4", quant_group_size=64, kv_quant=kv_quant)
    unfused, _ = _reports(_engine(TILE_CFG, **base))
    fused, _ = _reports(_engine(TILE_CFG, fused_decode_layer=True, **base))
    assert fused["layer_body_kernels"] == unfused["layer_body_kernels"] == 8
    ops_cut = 1 - fused["layer_body_ops"] / unfused["layer_body_ops"]
    major_cut = 1 - fused["layer_body_major"] / unfused["layer_body_major"]
    assert ops_cut >= cut, f"ops reduction {ops_cut:.0%} < {cut:.0%}"
    assert major_cut > 0, f"major-kernel count did not drop ({major_cut:.0%})"


@contextlib.asynccontextmanager
async def _stack(engine):
    serve_ch, proxy_ch = loopback_pair()
    ready = asyncio.get_running_loop().create_future()
    tasks = [asyncio.create_task(run_serve(serve_ch,
                                           backend=engine_backend(engine, "tiny"))),
             asyncio.create_task(run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))]
    try:
        yield f"http://127.0.0.1:{await asyncio.wait_for(ready, 10.0)}"
    finally:
        for t in tasks:
            t.cancel()
        serve_ch.close()
        await asyncio.gather(*tasks, return_exceptions=True)


@pytest.mark.parametrize("spec", [False, True])
def test_warmup_publishes_the_gauges(spec):
    engine = _engine(spec_ngram=3 if spec else 0, fused_decode_layer=True)

    async def main():
        for gauge in GAUGES:
            global_metrics.set_gauge(gauge, 0.0)
        await engine.start()
        try:
            await engine.warmup()
            gauges = {g: global_metrics.gauge(g) for g in GAUGES}
            report = await asyncio.get_running_loop().run_in_executor(
                None, engine.decode_launch_report)
            async with _stack(engine) as base:
                resp = await http11.http_request("GET", base + "/healthz")
                healthz = json.loads(await resp.read_all())
            return gauges, report, healthz
        finally:
            await engine.stop()

    gauges, report, healthz = asyncio.run(main())
    assert engine._warmup_done
    per_step = gauges["engine_decode_kernels_per_step"]
    assert per_step == report["layer_body_major"] > 0
    # decode, prefill, and the verify burst when speculation is on.
    assert gauges["engine_warmup_programs"] == (3 if spec else 2)
    total = gauges["engine_warmup_compile_s"]
    assert 0 < gauges["engine_warmup_compile_max_s"] <= total
    assert healthz["decode_kernels_per_step"] == per_step


def test_tp2_rank0_finishes_warmup_with_the_gauge(tmp_path):
    """The probe holds collectives: rank 0 dispatches it to its follower,
    which replays it (a probe of rank 0 alone would hang both)."""
    configs = {"raw": {}, "int4 fused": {"kv_quant": "int4",
                                        "fused_decode_layer": True}}
    lead, follower = run_ranks("warmup_gauges", 2,
                               dict(vocab=256, configs=configs), tmp_path)
    for name in configs:
        gauges, report = lead[name]["gauges"], lead[name]["report"]
        assert gauges["engine_decode_kernels_per_step"] == report["layer_body_major"] > 0
        assert report["layer_body_kernels"] == 1
        assert gauges["engine_warmup_programs"] == 2
        assert 0 < gauges["engine_warmup_compile_max_s"] <= gauges["engine_warmup_compile_s"]
        # decode warm, prefill warm, the gauge's probe, the report's probe.
        assert follower[name] == 4
