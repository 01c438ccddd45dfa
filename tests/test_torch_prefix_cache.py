"""The port's prefix cache (engine/prefix_cache.py) against the JAX
package's, on the CPU.

Host logic: both ``PrefixIndex`` implementations are driven with the same
seeded random operation sequence (match, missing, reserve/release,
allocate with costs, same-wave insert plans) and must return the same
values and reach the same counters after every step, under LRU and
cost-aware eviction.  Group admission planning, insert planning and the
copy-op padding helpers are compared on the same inputs.  Device side:
the batched copies are bit-exact against JAX's ``make_batch_copy_ops`` on
the same numpy cache and pool (they only move bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine import prefix_cache as jpc
from p2p_llm_tunnel_tpu_torch.engine import prefix_cache as tpc

BLOCK = 4


def _state(idx):
    return (idx.used_blocks, idx.free_blocks, idx.reserved_pages,
            idx.evictions, idx.hits, idx.lookups, idx.conv_hits,
            idx.conv_hit_tokens, idx.thrash_reallocs)


def _prompt(rng, prefixes):
    """A prompt that often shares a block-aligned prefix with earlier ones."""
    base = prefixes[rng.integers(len(prefixes))] if prefixes and rng.random() < 0.7 else []
    cut = (len(base) // BLOCK) * BLOCK
    keep = base[: rng.integers(0, cut + 1)] if cut else []
    tail = rng.integers(0, 50, size=int(rng.integers(1, 14))).tolist()
    return list(keep) + tail


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("evict", ["lru", "cost"])
def test_index_random_operation_sequence_matches_jax(evict, seed):
    rng = np.random.default_rng(seed)
    j = jpc.PrefixIndex(BLOCK, 9, evict=evict)
    t = tpc.PrefixIndex(BLOCK, 9, evict=evict)
    prompts, grants = [], []
    for step in range(160):
        op = rng.integers(6)
        p = _prompt(rng, prompts)
        prompts.append(p)
        if op == 0:
            assert t.match(p) == j.match(p), step
        elif op == 1:
            assert t.missing(p) == j.missing(p), step
        elif op == 2:
            n = int(rng.integers(0, 5))
            g = t.reserve(n)
            assert g == j.reserve(n), step
            grants.append(g)
        elif op == 3 and grants:
            g = grants.pop(int(rng.integers(len(grants))))
            t.release(g)
            j.release(g)
        elif op == 4:
            keys = [k for _, k in t.missing(p)]
            costs = [float(rng.integers(1, 100)) for _ in keys]
            conv = bool(rng.integers(2))
            assert t.allocate(keys, costs, conv) == j.allocate(keys, costs, conv)
        else:
            wave = [(s, _prompt(rng, prompts)) for s in range(int(rng.integers(1, 4)))]
            ms = float(rng.integers(1, 5))
            conv = bool(rng.integers(2))
            assert (tpc.plan_inserts(t, wave, ms_per_token=ms, conv=conv)
                    == jpc.plan_inserts(j, wave, ms_per_token=ms, conv=conv)), step
        assert _state(t) == _state(j), step
    assert t.evictions > 0  # the sequence really exercised eviction


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_group_admission_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    j = jpc.PrefixIndex(BLOCK, 33, evict="cost")
    t = tpc.PrefixIndex(BLOCK, 33, evict="cost")
    j_inflight, t_inflight = {}, {}
    shared = rng.integers(0, 50, size=12).tolist()
    rid = 0
    for wave_no in range(6):
        wave = []
        for _ in range(int(rng.integers(1, 6))):
            rid += 1
            head = shared if rng.random() < 0.6 else []
            wave.append((rid, head + rng.integers(0, 50, size=int(rng.integers(1, 10))).tolist()))
        got = tpc.plan_group_admission(t, t_inflight, wave)
        assert got == jpc.plan_group_admission(j, j_inflight, wave), wave_no
        assert t_inflight == j_inflight
        # Owners finish: their blocks land in the pool, their claims drop.
        for owner_rid, _hist, _ids, keys in got[0]:
            prompt = dict(wave)[owner_rid]
            assert (tpc.plan_inserts(t, [(0, prompt)])
                    == jpc.plan_inserts(j, [(0, prompt)]))
            for k in keys:
                t_inflight.pop(k, None)
                j_inflight.pop(k, None)
    assert _state(t) == _state(j)


def test_plan_inserts_same_wave_eviction_matches_jax():
    """A pool smaller than the wave: later allocations evict earlier
    same-wave keys, and both planners drop exactly the same pairs."""
    j = jpc.PrefixIndex(BLOCK, 4, evict="lru")
    t = tpc.PrefixIndex(BLOCK, 4, evict="lru")
    wave = [(0, list(range(12))), (1, list(range(20, 32))),
            (2, list(range(40, 48))), (3, list(range(12)))]
    got = tpc.plan_inserts(t, wave)
    assert got == jpc.plan_inserts(j, wave)
    flat = [i for _, ids, _ in got for i in ids]
    assert len(flat) == len(set(flat)) and _state(t) == _state(j)


@pytest.mark.parametrize("scratch", [None, 0])
def test_pad_rows_and_pad_ids_match_jax(scratch):
    entries = [(3, [5, 6, 7], [0, 1, 2]), (1, [9], [4])]
    for got, want in zip(tpc.pad_rows(entries, 4, 5, scratch),
                         jpc.pad_rows(entries, 4, 5, scratch)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(tpc.pad_ids([5, 6], [2, 3], 4, scratch),
                         jpc.pad_ids([5, 6], [2, 3], 4, scratch)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("direction", ["cache_to_pool", "blocks_to_cache"])
def test_batch_copy_ops_bit_exact_vs_jax(direction):
    rng = np.random.default_rng(4)
    l, slots, s, kh, d = 2, 5, 32, 2, 8
    block, cap, max_blocks, rows = BLOCK, 7, s // BLOCK, 3
    cache = {k: rng.standard_normal((l, slots, s, kh, d)).astype(np.float32)
             for k in ("k", "v")}
    pool = {k: rng.standard_normal((l, cap, block, kh, d)).astype(np.float32)
            for k in ("k", "v")}
    j_in, j_out = jpc.make_batch_copy_ops(block, max_blocks, rows)
    t_in, t_out = tpc.make_batch_copy_ops(block, max_blocks, rows)
    if direction == "cache_to_pool":
        entries = [(2, [3, 1], [0, 5]), (4, [6], [2])]
        args = jpc.pad_rows(entries, rows, max_blocks, scratch=0)
        want = j_out({k: jnp.asarray(v) for k, v in pool.items()},
                     {k: jnp.asarray(v) for k, v in cache.items()}, *args)
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        got = t_out(tpool, {k: torch.from_numpy(v) for k, v in cache.items()},
                    *tpc.pad_rows(entries, rows, max_blocks, scratch=0))
        assert got is tpool  # in place
        for k in pool:  # block 0 is scratch: junk by definition
            np.testing.assert_array_equal(got[k][:, 1:].numpy(),
                                          np.asarray(want[k])[:, 1:])
    else:
        entries = [(1, [2, 5, 4], [0, 1, 2]), (3, [6], [3])]
        args = jpc.pad_rows(entries, rows, max_blocks, scratch=None)
        want = j_in({k: jnp.asarray(v) for k, v in cache.items()},
                    {k: jnp.asarray(v) for k, v in pool.items()}, *args)
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        got = t_in(tcache, {k: torch.from_numpy(v) for k, v in pool.items()},
                   *tpc.pad_rows(entries, rows, max_blocks, scratch=None))
        assert got is tcache
        for k in cache:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_pool_mirrors_cache_and_refuses_quantized_caches():
    """Raw and quantized caches pool every leaf (scale planes included);
    packed int4 value planes take half-size byte pages, and an odd page
    size is refused under int4 (it would split a byte)."""
    cache = {k: torch.zeros((2, 3, 32, 2, 8), dtype=torch.bfloat16)
             for k in ("k", "v")}
    pool = tpc.init_pool(cache, BLOCK, 6)
    assert {k: tuple(v.shape) for k, v in pool.items()} == {
        "k": (2, 6, BLOCK, 2, 8), "v": (2, 6, BLOCK, 2, 8)}
    assert pool["k"].dtype == torch.bfloat16
    assert tpc.pool_packed_keys(cache) == frozenset()
    scales = {k: torch.zeros(2, 3, 32, 2) for k in ("k_scale", "v_scale")}
    int4 = {k: torch.zeros((2, 3, 16, 2, 8), dtype=torch.int8)
            for k in ("k", "v")}
    pool = tpc.init_pool(dict(int4, **scales), BLOCK, 6)
    assert {k: tuple(v.shape) for k, v in pool.items()} == {
        "k": (2, 6, BLOCK // 2, 2, 8), "v": (2, 6, BLOCK // 2, 2, 8),
        "k_scale": (2, 6, BLOCK, 2), "v_scale": (2, 6, BLOCK, 2)}
    assert tpc.pool_packed_keys(dict(int4, **scales)) == frozenset({"k", "v"})
    with pytest.raises(ValueError, match="even"):
        tpc.init_pool(dict(int4, **scales), 5, 6)
