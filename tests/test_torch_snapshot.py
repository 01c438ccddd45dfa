"""The port's prefix-pool snapshots (``--prefix-cache-dir``) against the
JAX package's, on the CPU.

Files: ``save_pool_snapshot`` of both packages over the same pool bytes
(fp32 and bf16; the port stores bf16 as its 2-byte ``int16`` view) and
the same index write the same version-3 manifest (pins, index rows,
``pool_checksum``) and the same npz bytes; the port's loader round-trips
its own files and refuses, with the index untouched, each case JAX's
loader refuses (tests/test_prefix_cache.py): absent or unreadable files,
version 2, a pin mismatch, halves from two saves, a leaf-set, shape or
dtype mismatch, and pool bytes that fail the checksum; its pin gate is
``verify_page_pin``.

Engines (tiny, fp32, the same bridged weights): an engine restored from
a snapshot hits the pool on its first request, before any prefill, and
its greedy stream equals the cold engine's and the JAX engine's, at kv
none/int8/int4; the restored pool's checksum is the saved one; an engine
at another ``kv_quant`` starts cold.  The pin fix holds in both
directions: a JAX engine's snapshot directory leaves a torch engine cold
and a torch engine's leaves a JAX engine cold, while each package
reloads its own — the two engines' pins differ in ``seed`` (and the
port's extra ``backend``) alone.
"""

import asyncio
import json
import os

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
from p2p_llm_tunnel_tpu_torch.engine import prefix_cache as tpc
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models import transformer as tt

WEIGHT_SEED = 3
ENGINE = dict(model="tiny", num_slots=4, max_seq=128, dtype="float32",
              min_prefill_bucket=16, decode_steps=4, mux=True,
              prefix_cache=True, prefill_chunk=16, prefix_pool_blocks=16)
PROMPT = list(b"You are a helpful assistant. Please answer: what?")
META = {"quant": "none", "kv_quant": "none", "group_size": 128}


def _pool(dtype):
    rng = np.random.default_rng(1)
    bits = rng.integers(-2 ** 15, 2 ** 15, size=(2, 4, 16, 2, 4), dtype=np.int16)
    if dtype == "bfloat16":
        return ({k: jnp.asarray(v.view(jnp.bfloat16)) for k, v in
                 (("k", bits), ("v", bits[::-1]))},
                {k: torch.from_numpy(v.copy()).view(torch.bfloat16) for k, v in
                 (("k", bits), ("v", bits[::-1]))})
    vals = rng.standard_normal((2, 4, 16, 2, 4)).astype(np.float32)
    return ({"k": jnp.asarray(vals), "v": jnp.asarray(-vals)},
            {"k": torch.from_numpy(vals.copy()), "v": torch.from_numpy(-vals)})


def _rows():
    return [["clock", 1.5], ["ab" * 16, 1, 2.0, 0, 2.0],
            ["cd" * 16, 3, 4.0, 1, 5.5], ["ef" * 16, -1, 1.0, 0, 1.0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_files_match_jax(tmp_path, dtype):
    jpool, tpool = _pool(dtype)
    j_idx, t_idx = jpc.PrefixIndex(16, 4), tpc.PrefixIndex(16, 4)
    j_idx.import_state(_rows())
    t_idx.import_state(_rows())
    jpc.save_pool_snapshot(str(tmp_path / "j"), jpool, j_idx, META)
    tpc.save_pool_snapshot(str(tmp_path / "t"), tpool, t_idx, META)
    mans = []
    for side in ("j", "t"):
        with open(tmp_path / side / "prefix_index.json") as f:
            man = json.load(f)
        mans.append({k: v for k, v in man.items() if k != "snap_id"})
    assert mans[0] == mans[1]
    assert mans[1]["version"] == 3 and mans[1]["pool_checksum"]
    with np.load(tmp_path / "j" / "prefix_pool.npz") as jz, \
            np.load(tmp_path / "t" / "prefix_pool.npz") as tz:
        for k in ("k", "v"):
            assert jz[k].tobytes() == tz[k].tobytes()


def _fixture(tmp_path):
    _jpool, pool = _pool("bfloat16")
    index = tpc.PrefixIndex(block=16, capacity=4)
    index.import_state(_rows())
    tpc.save_pool_snapshot(str(tmp_path), pool, index, META)
    return pool


def _load(tmp_path, pool, meta=META):
    fresh = tpc.PrefixIndex(block=16, capacity=4)
    out = tpc.load_pool_snapshot(
        str(tmp_path), {k: torch.zeros_like(v) for k, v in pool.items()},
        fresh, meta)
    return out, fresh


def test_snapshot_roundtrip(tmp_path):
    pool = _fixture(tmp_path)
    out, fresh = _load(tmp_path, pool)
    assert out is not None
    for k in pool:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16), pool[k].view(torch.int16))
    assert fresh.used_blocks == 2  # the tier marker is not resurrected


def _rewrite_npz(path, edit):
    with np.load(path) as npz:
        arrays = {k: npz[k].copy() for k in npz.files}
    edit(arrays)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _rewrite_manifest(path, edit):
    with open(path) as f:
        man = json.load(f)
    edit(man)
    with open(path, "w") as f:
        json.dump(man, f)


def _flip(arrays):
    arrays["k"][1, 3, 0, 0, 0] ^= 1


REFUSALS = {
    "absent": lambda d: os.remove(d / "prefix_pool.npz"),
    "manifest unreadable": lambda d: (d / "prefix_index.json").write_text("{nope"),
    "npz unreadable": lambda d: (d / "prefix_pool.npz").write_bytes(b"garbage"),
    "version 2": lambda d: _rewrite_manifest(
        d / "prefix_index.json", lambda m: (m.update(version=2), m.pop("pool_checksum"))),
    "pin mismatch": lambda d: _rewrite_manifest(
        d / "prefix_index.json", lambda m: m.update(kv_quant="int8")),
    "halves mismatch": lambda d: _rewrite_manifest(
        d / "prefix_index.json", lambda m: m.update(snap_id="0")),
    "leaf set": lambda d: _rewrite_npz(
        d / "prefix_pool.npz", lambda a: a.update(extra=a["k"])),
    "shape": lambda d: _rewrite_npz(
        d / "prefix_pool.npz", lambda a: a.update(k=a["k"][:, :3])),
    "dtype": lambda d: _rewrite_npz(
        d / "prefix_pool.npz", lambda a: a.update(k=a["k"].astype(np.float32))),
    "checksum": lambda d: _rewrite_npz(d / "prefix_pool.npz", _flip),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_snapshot_refusals_start_cold(tmp_path, case):
    """Each refusal: None, and the index untouched (still empty)."""
    pool = _fixture(tmp_path)
    REFUSALS[case](tmp_path)
    out, fresh = _load(tmp_path, pool)
    assert out is None, case
    assert fresh.used_blocks == 0 and fresh._clock == 0.0


def test_snapshot_pin_gate_is_verify_page_pin(tmp_path, monkeypatch):
    """The loader's compatibility gate IS the registered pin check: an
    always-refusing ``verify_page_pin`` forces a cold start."""
    pool = _fixture(tmp_path)

    def refuse(page, meta, want):
        raise tpc.PagePinError("refused by test")

    monkeypatch.setattr(tpc, "verify_page_pin", refuse)
    assert _load(tmp_path, pool)[0] is None


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                    torch.float32)


async def _serve(engine, max_new=8):
    """Start, one greedy request, stop (which saves a configured
    snapshot); returns (stream, pool hits before any prefill)."""
    hits0 = engine._prefix.match(PROMPT)[0]
    await engine.start()
    try:
        out = [ev.token_id async for ev in engine.generate(
            PROMPT, max_new_tokens=max_new, stop_ids=())]
    finally:
        await engine.stop()
    return out, hits0


@pytest.fixture(scope="module")
def jax_runs(weights, tmp_path_factory):
    """Per kv mode: the JAX engine's stream, and its snapshot directory."""
    jp, _ = weights
    memo = {}

    def get(kv_quant):
        if kv_quant not in memo:
            snap = str(tmp_path_factory.mktemp(f"jax-{kv_quant}"))
            eng = JInferenceEngine(engine_cfg=JEngineConfig(
                **ENGINE, kv_quant=kv_quant, prefix_cache_dir=snap), params=jp)

            async def run():
                await eng.start()
                try:
                    return [ev.token_id async for ev in eng.generate(
                        PROMPT, max_new_tokens=8, stop_ids=())]
                finally:
                    await eng.stop()
            memo[kv_quant] = (asyncio.run(run()), snap, eng._prefix_snapshot_meta())
        return memo[kv_quant]
    return get


def _torch(weights, snap, **kw):
    return InferenceEngine(engine_cfg=EngineConfig(
        **dict(ENGINE, prefix_cache_dir=snap, **kw)), params=weights[1],
        device="cpu")


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_restored_engine_matches_cold_and_jax(weights, jax_runs, tmp_path,
                                              kv_quant):
    want, _snap, _meta = jax_runs(kv_quant)
    snap = str(tmp_path / "pfx")
    cold, hits = asyncio.run(_serve(_torch(weights, snap, kv_quant=kv_quant)))
    assert hits == 0
    with open(os.path.join(snap, "prefix_index.json")) as f:
        saved = json.load(f)["pool_checksum"]
    warm = _torch(weights, snap, kv_quant=kv_quant)
    restored = {k: tpc.to_host(v) for k, v in warm._pool.items()}
    assert tpc.page_checksum(restored).hex() == saved
    out, hits = asyncio.run(_serve(warm))
    assert hits >= 2 * 16  # the pool answers before any prefill
    assert out == cold == want
    # Another KV format on the same directory starts cold.
    other = "int8" if kv_quant != "int8" else "int4"
    assert _torch(weights, snap, kv_quant=other)._prefix.used_blocks == 0


def test_snapshot_pins_refuse_the_other_package_both_ways(weights, jax_runs,
                                                          tmp_path):
    """JAX's snapshot directory leaves a torch engine cold, and a torch
    engine's leaves a JAX engine cold; each package reloads its own, and
    the pins differ in ``seed`` and ``backend`` alone."""
    jp, _ = weights
    want, jax_snap, jmeta = jax_runs("none")
    tmeta = _torch(weights, None)._prefix_snapshot_meta()
    assert {k for k in set(jmeta) | set(tmeta)
            if jmeta.get(k) != tmeta.get(k)} == {"seed", "backend"}
    assert tmeta["seed"] == "torch:0" and tmeta["backend"] == "torch"
    # JAX -> torch: cold, and the stream is a never-restored engine's.
    assert JInferenceEngine(engine_cfg=JEngineConfig(
        **ENGINE, prefix_cache_dir=jax_snap), params=jp)._prefix.used_blocks > 0
    t_eng = _torch(weights, jax_snap)
    assert t_eng._prefix.used_blocks == 0
    # torch -> JAX: save a torch snapshot, reload it in each package.
    snap = str(tmp_path / "torch")
    out, _ = asyncio.run(_serve(_torch(weights, snap)))
    assert out == want
    assert _torch(weights, snap)._prefix.used_blocks > 0
    j_eng = JInferenceEngine(engine_cfg=JEngineConfig(
        **ENGINE, prefix_cache_dir=snap), params=jp)
    assert j_eng._prefix.used_blocks == 0
    out, hits = asyncio.run(_serve(t_eng))
    assert (out, hits) == (want, 0)
