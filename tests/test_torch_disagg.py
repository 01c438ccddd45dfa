"""The port's disaggregated prefill/decode (``--role prefill|decode``:
KV_PAGES export and import) against the JAX package's, on the CPU.

The tiny model at fp32 on the same bridged weights.  A torch prefill
engine's export goes through the real frame codec (manifest to JSON and
back, blobs chunked under MAX_BODY_CHUNK and reassembled) into a torch
decode engine: every page splices, the decode peer's re-export carries
the sender's checksums bit for bit, and its greedy stream equals the JAX
engine's, at kv none/int8/int4.  bf16 pages travel under the wire dtype
``"bfloat16"`` as 2-byte views, and JAX's own blob parser reads them to
the same checksums.  The pin fix, both directions: a JAX export offered
to a torch decode engine, and a torch export offered to a JAX one, raise
``PagePinError`` with ``tunnel_code == "page_pin"`` before any page
splices, and the receiver's local re-prefill equals a never-offered run.
The two-engine fabric — prefill and decode peers behind one
``run_proxy_fabric`` with ``ProxyState(fabric=True)``, each on its own
``loopback_pair`` — hands pages off through the tunnel with no fallback.
Role fences: a split role without the prefix cache falls back to "both"
with a recorded fence, an unknown role raises, and a prompt shorter than
one block exports nothing at once.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine import prefix_cache as jpc
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.models.config import get_config
from p2p_llm_tunnel_tpu.models.transformer import init_params
from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import ProxyState, run_proxy_fabric
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.engine import prefix_cache as tpc
from p2p_llm_tunnel_tpu_torch.engine.api import engine_backend
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.tokenizer import NumericTokenizer
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    MAX_BODY_CHUNK,
    KvPagesManifest,
    TunnelMessage,
)
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

WEIGHT_SEED = 3
ENGINE = dict(model="tiny", num_slots=4, max_seq=128, dtype="float32",
              min_prefill_bucket=16, decode_steps=4, mux=True,
              prefix_cache=True, prefill_chunk=16)
PROMPT = list(range(1, 57))  # 3 full 16-token blocks + a tail


@pytest.fixture(scope="module")
def weights():
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                    torch.float32)


def _torch(weights, role="both", **kw):
    return InferenceEngine(engine_cfg=EngineConfig(**dict(ENGINE, role=role, **kw)),
                           params=weights[1], device="cpu",
                           tokenizer=NumericTokenizer())


async def _drain(engine, prompt=PROMPT, max_new=6):
    return [ev.token_id async for ev in engine.generate(
        prompt, max_new_tokens=max_new, stop_ids=())]


@pytest.fixture(scope="module")
def jax_runs(weights):
    """Per kv mode, one JAX prefill-role engine (a full engine too): its
    greedy stream on PROMPT and its export of PROMPT's pages."""
    jp, _ = weights
    memo = {}

    def get(kv_quant):
        if kv_quant not in memo:
            eng = JInferenceEngine(engine_cfg=JEngineConfig(
                **ENGINE, kv_quant=kv_quant, role="prefill"), params=jp)

            async def run():
                await eng.start()
                try:
                    out = await _drain(eng)
                    return out, await eng.export_kv_pages(PROMPT)
                finally:
                    await eng.stop()
            memo[kv_quant] = asyncio.run(run())
        return memo[kv_quant]
    return get


def _wire_roundtrip(export):
    """An export through the port's frame codec, as a tunnel receiver
    would get it: manifest JSON in a KV_PAGES_HDR frame, blobs in
    KV_PAGES_CHUNK frames under MAX_BODY_CHUNK, reassembled."""
    manifest = KvPagesManifest(stream_id=5, meta=dict(export["meta"]),
                               pages=list(export["pages"]))
    hdr = TunnelMessage.decode(TunnelMessage.kv_pages_hdr(manifest).encode())
    again = KvPagesManifest.from_json(hdr.payload)
    blob = b"".join(export["blobs"])
    buf = bytearray()
    for lo in range(0, len(blob), MAX_BODY_CHUNK):
        frame = TunnelMessage.kv_pages_chunk(5, blob[lo : lo + MAX_BODY_CHUNK]).encode()
        buf.extend(TunnelMessage.decode(frame).payload)
    assert again.total_bytes() == len(buf)
    blobs, off = [], 0
    for spec in again.pages:
        n = int(spec["nbytes"])
        blobs.append(bytes(buf[off : off + n]))
        off += n
    return again, blobs


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_torch_splice_matches_jax_every_kv_mode(weights, jax_runs, kv_quant):
    want, _ = jax_runs(kv_quant)

    async def main():
        pre = _torch(weights, "prefill", kv_quant=kv_quant)
        dec = _torch(weights, "decode", kv_quant=kv_quant)
        await pre.start()
        await dec.start()
        try:
            await _drain(pre, max_new=1)  # the export probe
            export = await pre.export_kv_pages(PROMPT)
            assert export is not None and len(export["pages"]) == 3
            manifest, blobs = _wire_roundtrip(export)
            assert await dec.import_kv_pages(manifest.meta, manifest.pages, blobs) == 3
            out = await _drain(dec)
            back = await dec.export_kv_pages(PROMPT)
            assert [p["checksum"] for p in back["pages"][:3]] == [
                p["checksum"] for p in export["pages"]]
            assert pre.disagg_stats()["pages_shipped"] == 3
            stats = dec.disagg_stats()
            assert (stats["role"], stats["pages_spliced"], stats["xfer_inflight"]) == (
                "decode", 3, 0)
            return out
        finally:
            await pre.stop()
            await dec.stop()

    assert asyncio.run(main()) == want


def test_bf16_pages_use_the_jax_wire_format(weights):
    """A bf16 export names its leaves ``"bfloat16"``; JAX's own blob
    parser (ml_dtypes) reads each page to the sender's checksum, and the
    port's parser to the same bytes as 2-byte views."""
    async def main():
        pre = _torch(weights, "prefill", dtype="bfloat16")
        await pre.start()
        try:
            await _drain(pre, max_new=1)
            return await pre.export_kv_pages(PROMPT)
        finally:
            await pre.stop()

    export = asyncio.run(main())
    for spec, blob in zip(export["pages"], export["blobs"]):
        assert {leaf["dtype"] for leaf in spec["leaves"].values()} == {"bfloat16"}
        j_pay = JInferenceEngine._blob_to_payload(spec, blob)
        t_pay = InferenceEngine._blob_to_payload(spec, blob)
        assert {str(v.dtype) for v in t_pay.values()} == {"int16"}
        assert (jpc.page_checksum(j_pay).hex() == tpc.page_checksum(t_pay).hex()
                == spec["checksum"])


def test_jax_pages_refused_by_torch_then_local_reprefill(weights, jax_runs):
    want, export = jax_runs("none")
    assert export is not None and len(export["pages"]) == 3

    async def main():
        dec = _torch(weights, "decode")
        await dec.start()
        try:
            manifest, blobs = _wire_roundtrip(export)
            before = global_metrics.counter("engine_page_refusals_total")
            with pytest.raises(tpc.PagePinError, match="seed") as e:
                await dec.import_kv_pages(manifest.meta, manifest.pages, blobs)
            assert e.value.tunnel_code == "page_pin"
            assert global_metrics.counter("engine_page_refusals_total") == before + 1
            assert dec._prefix.wire_spliced == 0 and dec._prefix.used_blocks == 0
            return await _drain(dec)
        finally:
            await dec.stop()

    assert asyncio.run(main()) == want


def test_torch_pages_refused_by_jax_then_local_reprefill(weights, jax_runs):
    jp, _ = weights
    want, _ = jax_runs("none")

    async def main():
        pre = _torch(weights, "prefill")
        await pre.start()
        try:
            await _drain(pre, max_new=1)
            export = await pre.export_kv_pages(PROMPT)
        finally:
            await pre.stop()
        assert export["meta"]["seed"] == "torch:0"
        dec = JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE, role="decode"),
                               params=jp)
        await dec.start()
        try:
            manifest, blobs = _wire_roundtrip(export)
            with pytest.raises(jpc.PagePinError, match="seed") as e:
                await dec.import_kv_pages(manifest.meta, manifest.pages, blobs)
            assert e.value.tunnel_code == "page_pin"
            assert dec._prefix.wire_spliced == 0
            return await _drain(dec)
        finally:
            await dec.stop()

    assert asyncio.run(main()) == want


async def _completion(base: str, max_tokens: int = 6):
    body = {"prompt": PROMPT, "max_tokens": max_tokens, "temperature": 0,
            "ignore_eos": True}
    resp = await http11.http_request(
        "POST", base + "/v1/completions", {"content-type": "application/json"},
        json.dumps(body).encode(), timeout=120.0)
    assert resp.status == 200
    text = json.loads(await resp.read_all())["choices"][0]["text"]
    return [int(t) for t in text.split()]


def test_two_engine_fabric_hands_pages_off_through_the_tunnel(weights, jax_runs):
    """Prefill and decode peers behind one fabric proxy: the proxy has
    the prefill peer export the prompt's pages and splices them into the
    decode peer before the request goes out; the stream is the JAX
    engine's, with no fallback and no transfer left in flight."""
    want, _ = jax_runs("none")
    counters = ("proxy_disagg_fallbacks_total", "proxy_disagg_handoffs_total",
                "engine_pages_shipped_total", "engine_pages_spliced_total")

    async def main():
        engines = {"prefill-0": _torch(weights, "prefill"),
                   "decode-0": _torch(weights, "decode")}
        state = ProxyState(tenant_fallback="local", fabric=True)
        tasks, chans = [], []
        for pid, eng in engines.items():
            await eng.start()
            serve_ch, proxy_ch = loopback_pair()
            chans.append(serve_ch)
            tasks.append(asyncio.create_task(run_serve(
                serve_ch, backend=engine_backend(eng, "tiny"), max_inflight=64)))
            await state.admit(proxy_ch, pid)
        ready = asyncio.get_running_loop().create_future()
        tasks.append(asyncio.create_task(run_proxy_fabric(
            state, "127.0.0.1", 0, ready=ready)))
        before = {c: global_metrics.counter(c) for c in counters}
        try:
            port = await asyncio.wait_for(ready, 10.0)
            out = await _completion(f"http://127.0.0.1:{port}")
            deltas = {c: global_metrics.counter(c) - before[c] for c in counters}
            stats = {pid: eng.disagg_stats() for pid, eng in engines.items()}
        finally:
            for t in tasks:
                t.cancel()
            for ch in chans:
                ch.close()
            await asyncio.gather(*tasks, return_exceptions=True)
            for eng in engines.values():
                await eng.stop()
        return out, deltas, stats

    out, deltas, stats = asyncio.run(main())
    assert out == want
    assert deltas["proxy_disagg_fallbacks_total"] == 0
    assert deltas["proxy_disagg_handoffs_total"] == 1
    assert deltas["engine_pages_shipped_total"] == deltas["engine_pages_spliced_total"] == 3
    assert stats["prefill-0"]["pages_shipped"] == 3
    assert stats["decode-0"]["pages_spliced"] == 3
    assert stats["prefill-0"]["xfer_inflight"] == stats["decode-0"]["xfer_inflight"] == 0


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_split_role_fenced_without_prefix_cache(weights, role):
    eng = _torch(weights, role, prefix_cache=False)
    assert eng.ecfg.role == "both"
    assert [f["knob"] for f in eng.config_fences] == ["role"]
    assert eng.disagg_stats()["role"] == "both"


def test_unknown_role_raises(weights):
    with pytest.raises(ValueError, match="role"):
        _torch(weights, "router")


def test_subblock_prompt_exports_nothing_at_once(weights):
    async def main():
        eng = _torch(weights, "prefill")
        await eng.start()
        try:
            await _drain(eng, [1, 2, 3], max_new=1)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            assert await eng.export_kv_pages([1, 2, 3]) is None
            assert loop.time() - t0 < 1.0  # no residency poll for nothing
        finally:
            await eng.stop()

    asyncio.run(main())
