"""The port's host-RAM spill tier (engine/prefix_cache.py + the engine's
drains) against the JAX package's, on the CPU.

Host logic: both ``PrefixIndex`` implementations with a spill tier are
driven with the same seeded random sequence of allocate, evict (through
allocation and reservation), match, spill-plan, note-spilled, spill
extension, page-in claim/commit/abort (tier and wire-offered) and
export/import of state, and must return the same values and reach the
same counters after every step.  ``page_checksum`` and the page bytes of
one pool page agree between JAX's ``make_spill_ops`` (ml_dtypes bf16 on
the host) and the port's ``page_out`` (bf16 as its 2-byte view), raw,
int8 and packed int4.

Engine: the tiny model at fp32 on the same weights (JAX ``init_params``
bridged with ``params_from_numpy``) runs the A/B/A turn shape (B and C
evict A's pages, A's return pages them back in) with a 6-block pool:
the port's greedy streams with the tier on equal the port's with it off
and the JAX engine's, at kv none/int8/int4, while pages really went out
and came back.  A seeded ``TUNNEL_SPILL_CHAOS`` corrupt schedule must be
caught by every page-in's checksum and fall back to re-prefill with the
same streams; both tiers exhausted answer the typed ``"memory"``
verdict; the tier is fenced without the prefix cache.
"""

import asyncio

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
from p2p_llm_tunnel_tpu_torch.utils.flight import global_flight
from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

BLOCK = 4
WEIGHT_SEED = 3  # tie-free for the A/B/A turns below
ENGINE = dict(model="tiny", num_slots=4, max_seq=128, dtype="float32",
              min_prefill_bucket=16, decode_steps=4, mux=True,
              prefix_cache=True, prefill_chunk=16, prefix_pool_blocks=6,
              prefix_evict="cost")


def _state(idx):
    return (idx.used_blocks, idx.free_blocks, idx.reserved_pages,
            idx.evictions, idx.hits, idx.lookups, idx.thrash_reallocs,
            idx.spill_resident, idx.spill_pageouts, idx.spill_pageins,
            idx.spill_drops, idx.wire_spliced)


def _prompt(rng, prefixes):
    """A prompt that often shares a block-aligned prefix with earlier ones."""
    base = prefixes[rng.integers(len(prefixes))] if prefixes and rng.random() < 0.7 else []
    cut = (len(base) // BLOCK) * BLOCK
    keep = base[: rng.integers(0, cut + 1)] if cut else []
    tail = rng.integers(0, 50, size=int(rng.integers(1, 14))).tolist()
    return list(keep) + tail


def _payload(rng):
    return {"k": rng.integers(0, 255, size=(2, BLOCK, 3), dtype=np.uint8),
            "v": rng.integers(0, 255, size=(2, BLOCK, 3), dtype=np.uint8)}


def _claims(items):
    return [(k, i, jpc.page_checksum(p.payload)) for k, i, p in items]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("evict", ["lru", "cost"])
def test_spill_index_random_operation_sequence_matches_jax(evict, seed):
    rng = np.random.default_rng(seed)
    j = jpc.PrefixIndex(BLOCK, 9, evict=evict, spill_pages=5)
    t = tpc.PrefixIndex(BLOCK, 9, evict=evict, spill_pages=5)
    prompts, grants = [], []
    for step in range(200):
        op = int(rng.integers(9))
        if op in (5, 6) and prompts:
            # A returning prompt, preferably one whose chain continues
            # into the tier (the index states are equal, so t decides).
            back = [q for q in prompts if t.spill_extension(q)] or prompts
            p = back[int(rng.integers(len(back)))]
        else:
            p = _prompt(rng, prompts)
            prompts.append(p)
        if op == 0:
            assert t.match(p) == j.match(p), step
        elif op == 1:
            n = int(rng.integers(0, 5))
            g = t.reserve(n)
            assert g == j.reserve(n), step
            grants.append(g)
        elif op == 2 and grants:
            g = grants.pop(int(rng.integers(len(grants))))
            t.release(g)
            j.release(g)
        elif op == 3:
            keys = [k for _, k in t.missing(p)]
            costs = [float(rng.integers(1, 100)) for _ in keys]
            conv = bool(rng.integers(2))
            assert t.allocate(keys, costs, conv) == j.allocate(keys, costs, conv)
        elif op == 4:
            n = int(rng.integers(0, 4))
            excl = frozenset(t.chain_keys(p)) if rng.random() < 0.5 else frozenset()
            plan = t.spill_plan(n, exclude=excl)
            assert plan == j.spill_plan(n, exclude=excl), step
            for key, _ in plan:
                pay = _payload(rng)
                ck = tpc.page_checksum(pay)
                assert ck == jpc.page_checksum(pay)
                assert (t.note_spilled(key, pay, ck, {"kv_quant": "none"})
                        == j.note_spilled(key, pay, ck, {"kv_quant": "none"})), step
        elif op == 5:
            assert t.spill_extension(p) == j.spill_extension(p), step
        elif op == 6:
            ext = [k for _, k in t.spill_extension(p)]
            assert ext == [k for _, k in j.spill_extension(p)]
            prot = frozenset(t.chain_keys(p))
            assert prot == frozenset(j.chain_keys(p))
            t.touch_resident(prot)
            j.touch_resident(prot)
            got = t.page_in_alloc(ext, protect=prot)
            want = j.page_in_alloc(ext, protect=prot)
            assert _claims(got) == _claims(want), step
            for key, idx, _ in got:
                if rng.random() < 0.7:
                    t.commit_page_in(key, idx)
                    j.commit_page_in(key, idx)
                else:
                    t.abort_page_in(key, idx)
                    j.abort_page_in(key, idx)
        elif op == 7:
            # Wire-offered pages: the KV_PAGES splice path.
            keys = [k for _, k in t.missing(p)]
            pay = _payload(rng)
            ck = tpc.page_checksum(pay)
            t_off = {k: tpc._SpillPage(pay, ck, {}, cost=3.0) for k in keys}
            j_off = {k: jpc._SpillPage(pay, ck, {}, cost=3.0) for k in keys}
            got = t.page_in_alloc(keys, protect=frozenset(keys), offered=t_off)
            want = j.page_in_alloc(keys, protect=frozenset(keys), offered=j_off)
            assert _claims(got) == _claims(want), step
            for key, idx, _ in got:
                t.commit_page_in(key, idx, page=t_off[key])
                j.commit_page_in(key, idx, page=j_off[key])
        else:
            wave = [(s, _prompt(rng, prompts)) for s in range(int(rng.integers(1, 4)))]
            ms = float(rng.integers(1, 5))
            assert (tpc.plan_inserts(t, wave, ms_per_token=ms)
                    == jpc.plan_inserts(j, wave, ms_per_token=ms)), step
        assert _state(t) == _state(j), step
        assert t.export_state() == j.export_state(), step
    # The sequence really exercised the tier in both directions.
    assert t.spill_pageouts > 0 and t.spill_pageins > 0 and t.wire_spliced > 0
    assert t.evictions > 0 and t.spill_drops > 0
    # Snapshot rows restore identically (tier markers skipped).
    rows = t.export_state()
    assert any(r[1] == -1 for r in rows[1:])
    t2 = tpc.PrefixIndex(BLOCK, 9, evict=evict, spill_pages=5)
    j2 = jpc.PrefixIndex(BLOCK, 9, evict=evict, spill_pages=5)
    t2.import_state(rows)
    j2.import_state(rows)
    assert _state(t2) == _state(j2) and t2.export_state() == j2.export_state()


@pytest.mark.parametrize("form", ["bfloat16", "int8", "int4"])
def test_page_out_bytes_and_checksum_match_jax(form):
    """One pool page through JAX's ``make_spill_ops`` (ml_dtypes bf16 on
    the host) and the port's ``page_out`` (bf16 as ``int16``): the same
    bytes, so the same ``page_checksum``; ``page_in`` writes them back
    into exactly that slot."""
    rng = np.random.default_rng(7)
    l, cap, kh, d = 2, 5, 2, 8
    if form == "bfloat16":
        bits = rng.integers(-2 ** 15, 2 ** 15, size=(l, cap, BLOCK, kh, d),
                            dtype=np.int16)
        host = {"k": bits, "v": bits[::-1].copy()}
        jpool = {k: jnp.asarray(v.view(jnp.bfloat16)) for k, v in host.items()}
        tpool = {k: torch.from_numpy(v.copy()).view(torch.bfloat16)
                 for k, v in host.items()}
    else:
        unit = BLOCK // 2 if form == "int4" else BLOCK
        host = {k: rng.integers(-128, 128, size=(l, cap, unit, kh, d),
                                dtype=np.int8) for k in ("k", "v")}
        host.update({k: rng.standard_normal((l, cap, BLOCK, kh)).astype(np.float32)
                     for k in ("k_scale", "v_scale")})
        jpool = {k: jnp.asarray(v) for k, v in host.items()}
        tpool = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    j_out, _j_in = jpc.make_spill_ops()
    want = {k: np.asarray(v) for k, v in j_out(jpool, jnp.int32(3)).items()}
    got = tpc.page_out(tpool, 3)
    assert set(got) == set(want)
    for k in got:
        assert got[k].tobytes() == want[k].tobytes()
    assert tpc.page_checksum(got) == jpc.page_checksum(want)
    # The payload is a copy: writing the pool leaves it alone.
    before = tpc.page_checksum(got)
    for v in tpool.values():
        v.zero_()
    assert tpc.page_checksum(got) == before
    tpc.page_in(tpool, 2, got)
    for k, v in tpool.items():
        back = tpc.to_host(v)
        assert back[:, 2].tobytes() == got[k].tobytes()
        assert not back[:, [0, 1, 3, 4]].any()


def test_verify_page_pin_names_the_first_mismatch():
    meta = {"kv_quant": "int8", "backend": "torch"}
    assert tpc.verify_page_pin("p", meta, meta) == "p"
    with pytest.raises(tpc.PagePinError, match="backend") as e:
        tpc.verify_page_pin("p", {"kv_quant": "int8"}, meta)
    assert e.value.tunnel_code == jpc.PagePinError.tunnel_code == "page_pin"


# ---------------------------------------------------------------------------
# engine: spill on == spill off == the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = init_params(get_config("tiny", vocab_size=259),
                     jax.random.PRNGKey(WEIGHT_SEED), jnp.float32)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                    torch.float32)


def _aba_prompts():
    a = list(range(1, 52)) + [250]
    b = list(range(100, 151)) + [251]
    c = list(range(200, 251)) + [252]
    return [a, b, c, a]  # B and C evict A's pages; A's return pages them in


async def _turns(engine, prompts, max_new=6):
    """Sequential turns, each followed by idle iterations so the
    end-of-iteration spill drain pages the finished turn's pages out."""
    await engine.start()
    try:
        streams = []
        for p in prompts:
            streams.append([ev.token_id async for ev in engine.generate(
                p, max_new_tokens=max_new, stop_ids=())])
            await asyncio.sleep(0.05)
        return streams
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's A/B/A streams (spill off), one engine per kv mode."""
    jp, _ = weights
    memo = {}

    def get(kv_quant):
        if kv_quant not in memo:
            memo[kv_quant] = asyncio.run(_turns(JInferenceEngine(
                engine_cfg=JEngineConfig(**ENGINE, kv_quant=kv_quant),
                params=jp), _aba_prompts()))
        return memo[kv_quant]
    return get


def _torch(weights, **kw):
    return InferenceEngine(engine_cfg=EngineConfig(**dict(ENGINE, **kw)),
                           params=weights[1], device="cpu")


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_spill_on_off_identity_matches_jax(weights, jax_streams, kv_quant,
                                           monkeypatch):
    monkeypatch.delenv("TUNNEL_SPILL_CHAOS", raising=False)
    off = asyncio.run(_turns(_torch(weights, kv_quant=kv_quant), _aba_prompts()))
    before = global_metrics.counter("engine_spill_pageins_total")
    eng = _torch(weights, kv_quant=kv_quant, spill_pages=8)
    on = asyncio.run(_turns(eng, _aba_prompts()))
    assert on == off == jax_streams(kv_quant)
    pi = eng._prefix
    assert pi.spill_pageouts > 0
    assert pi.spill_pageins > 0, "A's return never touched the tier"
    assert global_metrics.counter("engine_spill_pageins_total") - before == pi.spill_pageins
    assert eng._spill_inflight == 0
    state = eng._blackbox_state()["prefix_pool"]
    assert state["spill_pages"] == pi.spill_resident > 0
    assert state["spill_inflight"] == 0
    recs = global_flight.records()
    assert sum(r.get("spill_pageins", 0) for r in recs) >= pi.spill_pageins


def test_spill_chaos_corrupt_pagein_falls_back_byte_identical(
        weights, jax_streams, monkeypatch):
    """Seeded corrupt=1.0 poisons EVERY page-in copy: each checksum must
    refuse it and the request re-prefill, with the clean streams."""
    monkeypatch.setenv("TUNNEL_SPILL_CHAOS", "corrupt=1.0,seed=5")
    eng = _torch(weights, spill_pages=8)
    faulted = asyncio.run(_turns(eng, _aba_prompts()))
    assert faulted == jax_streams("none")
    kinds = {k for _, op, k in eng._spill_chaos.faults if op == "pagein"}
    assert kinds == {"corrupt"}
    assert eng._prefix.spill_pageins == 0  # every splice was refused


def test_spill_chaos_two_run_engine_fault_identity(weights, jax_streams,
                                                   monkeypatch):
    """Two runs under one seeded drop/corrupt schedule record the same
    faults and streams, and every fault degrades to re-prefill.  Pages
    are priced by the live per-token prefill time, so that estimate is
    held at its unmeasured value: both runs then plan the same page
    moves whatever the machine's load."""
    def run():
        monkeypatch.setenv("TUNNEL_SPILL_CHAOS", "drop=0.4,corrupt=0.4,seed=5")
        eng = _torch(weights, spill_pages=8)
        eng._note_prefill_cost = lambda tokens, wall_ms: None
        return asyncio.run(_turns(eng, _aba_prompts())), eng._spill_chaos.faults

    s1, f1 = run()
    s2, f2 = run()
    assert (s1, f1) == (s2, f2) and f1
    assert s1 == jax_streams("none")


def test_memory_exhaustion_admission_verdict(weights):
    """Both tiers exhausted -> the typed "memory" verdict before any queue
    arithmetic, counted; it clears with the pressure."""
    eng = _torch(weights, spill_pages=2, max_waiting=64)
    pi = eng._prefix
    assert eng.admission_check(1) is None
    pi.reserved_pages = pi.capacity - 1  # the pool fully reserved
    assert eng.admission_check(1) is None  # the tier still has room
    for n in range(pi.spill_pages):
        pi._spill[n.to_bytes(16, "big")] = tpc._SpillPage({}, b"", {})
    before = global_metrics.counter("engine_memory_shed_total")
    assert eng.admission_check(1) == "memory"
    assert global_metrics.counter("engine_memory_shed_total") == before + 1
    pi.reserved_pages = 0
    assert eng.admission_check(1) is None
    # Without a tier the verdict never fires (eviction alone handles it).
    plain = _torch(weights, max_waiting=64)
    plain._prefix.reserved_pages = plain._prefix.capacity - 1
    assert plain.admission_check(1) is None


def test_spill_fenced_without_prefix_cache(weights):
    eng = _torch(weights, prefix_cache=False, spill_pages=8)
    assert eng.ecfg.spill_pages == 0
    assert any(f["knob"] == "spill_pages" for f in eng.config_fences)
    assert not eng._spill_meta and eng._prefix is None


def test_spill_pages_pinned_to_their_package_both_ways(weights):
    """The spill pin is the snapshot's: a page carrying a JAX engine's
    pins never splices into a torch engine's pool, nor a torch page into
    a JAX engine's (each page-in refuses and the slot goes back), while
    each engine splices a page carrying its own pins."""
    jp, _ = weights
    t_eng = _torch(weights, spill_pages=8)
    j_eng = JInferenceEngine(engine_cfg=JEngineConfig(**ENGINE, spill_pages=8),
                             params=jp)
    tmeta, jmeta = t_eng._spill_meta, j_eng._spill_meta
    assert {k for k in set(tmeta) | set(jmeta)
            if tmeta.get(k) != jmeta.get(k)} == {"seed", "backend"}
    key = bytes(16)
    t_pay = tpc.page_out(t_eng._pool, 2)
    j_pay = {k: np.asarray(v) for k, v in jpc.make_spill_ops()[0](
        j_eng._pool, jnp.int32(2)).items()}
    for eng, pc, pay, own, other in ((t_eng, tpc, t_pay, tmeta, jmeta),
                                     (j_eng, jpc, j_pay, jmeta, tmeta)):
        ck = pc.page_checksum(pay)
        refused = eng._spill_copy_in([(key, 3, pc._SpillPage(pay, ck, dict(other)))])
        spliced = eng._spill_copy_in([(key, 3, pc._SpillPage(pay, ck, dict(own)))])
        assert (refused, spliced) == ([(key, 3, False)], [(key, 3, True)])
