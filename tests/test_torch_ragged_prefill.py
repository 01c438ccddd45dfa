"""Kernel 6 (ragged grouped prefill) and the chunk-prefill path of the
port against the JAX package, on the CPU.

- The planner is the reference's; it is compared on the reference test's
  ``ENTRIES`` and error cases.
- The kernel's plain version (the wrapper on CPU tensors) is held against
  the JAX Pallas kernel run in interpret mode, fp32: attention within
  2e-4 abs/rel (tests/test_ragged_prefill.py's own tolerance), the written
  cache rows within 1e-6, the rest of the cache untouched.
- Model level, fp32 on ``tiny`` with bridged weights:
  ``chunk_prefill_into_cache`` and ``ragged_prefill_into_cache`` against
  JAX's ``chunk_prefill_into_cache`` (logits 1e-4, cache 1e-5, the fp32
  tolerances of tests/test_torch_transformer.py); with ``starts == 0``
  both equal the port's own ``prefill_into_cache``; one bf16 case at
  the port's bf16 bound (2.5% of the logits' range,
  tests/test_torch_transformer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.ops.pallas_prefill_attention import (
    plan_ragged_group as j_plan,
    ragged_prefill_attention as j_ragged,
)
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as tpa

THETA = 10000.0
ENTRIES = [(0, 32, 20), (1, 0, 7), (2, 16, 33), (3, 0, 16)]
VOCAB = 300
BF16_REL = 0.025  # tests/test_torch_transformer.py


def test_plan_ragged_group_matches_jax():
    for kw in (dict(), dict(max_row_blocks=3)):
        got = tpa.plan_ragged_group(ENTRIES, 16, 128, scratch_slot=9, **kw)
        want = j_plan(ENTRIES, 16, 128, scratch_slot=9, **kw)
        for g, w in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(g, w)
        assert got[5] == want[5] == [0, 32, 48, 96]


@pytest.mark.parametrize("entries,bq,tot,match", [
    ([(0, 13, 8)], 16, 64, "multiple of the q-block"),
    ([(0, 0, 60), (1, 0, 60)], 16, 96, "overflows"),
    ([(0, 0, 0)], 16, 64, "tail_len"),
    ([(0, 0, 8)], 16, 72, "not a multiple"),
    ([(0, 0, 40)], 16, 64, "per-row bound"),
])
def test_plan_ragged_group_errors_match_jax(entries, bq, tot, match):
    kw = dict(max_row_blocks=2) if match == "per-row bound" else {}
    with pytest.raises(ValueError, match=match):
        tpa.plan_ragged_group(entries, bq, tot, scratch_slot=1, **kw)
    with pytest.raises(ValueError):
        j_plan(entries, bq, tot, scratch_slot=1, **kw)


def _kernel_inputs(seed, s=128, tot=128, bq=16):
    rng = np.random.default_rng(seed)
    l, b, kh, g, d = 2, 4, 2, 2, 32
    h = kh * g
    entries = ENTRIES[:3]
    plan = tpa.plan_ragged_group(entries, bq, tot, scratch_slot=3)
    hist_k = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    hist_v = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    q = np.zeros((tot, h, d), np.float32)
    kn = np.zeros((tot, kh, d), np.float32)
    vn = np.zeros((tot, kh, d), np.float32)
    for (_slot, _start, ln), off in zip(entries, plan[5]):
        q[off:off + ln] = rng.standard_normal((ln, h, d))
        kn[off:off + ln] = rng.standard_normal((ln, kh, d))
        vn[off:off + ln] = rng.standard_normal((ln, kh, d))
    return entries, plan, (hist_k, hist_v), (q, kn, vn)


@pytest.mark.parametrize("kw", [dict(), dict(window=24, softcap=20.0)])
def test_plain_version_matches_pallas_interpret(kw):
    entries, plan, (hk, hv), (q, kn, vn) = _kernel_inputs(seed=len(kw))
    slot_of, start_of, qoff_of, _qlen, base_of, offs = plan
    layer = 1
    attn_j, kc_j, vc_j, _, _ = j_ragged(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(hk), jnp.asarray(hv), None, None,
        *(jnp.asarray(x) for x in (slot_of, start_of, qoff_of, base_of)),
        jnp.asarray(layer), block_q=16, rope_theta=THETA, interpret=True, **kw)
    tk, tv = torch.from_numpy(hk.copy()), torch.from_numpy(hv.copy())
    attn_t = tpa.ragged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
        *(torch.from_numpy(x) for x in (slot_of, start_of, qoff_of, base_of)),
        layer, block_q=16, rope_theta=THETA, **kw)
    kc_j, vc_j = np.asarray(kc_j), np.asarray(vc_j)
    for (slot, start, ln), off in zip(entries, offs):
        np.testing.assert_allclose(attn_t[off:off + ln].numpy(),
                                   np.asarray(attn_j)[off:off + ln],
                                   rtol=2e-4, atol=2e-4)
        for got, want in ((tk, kc_j), (tv, vc_j)):
            np.testing.assert_allclose(got[layer, slot, start:start + ln].numpy(),
                                       want[layer, slot, start:start + ln],
                                       rtol=1e-6, atol=1e-6)
    # Other layers, the untouched slot, and every history region: as given.
    np.testing.assert_array_equal(tk[0].numpy(), hk[0])
    for slot, start, _ in entries:
        np.testing.assert_array_equal(tk[layer, slot, :start].numpy(),
                                      hk[layer, slot, :start])


def test_wrapper_checks_geometry():
    q = torch.zeros((32, 4, 16))
    kv = torch.zeros((32, 2, 16))
    cache = torch.zeros((1, 2, 40, 2, 16))
    d = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_seq 40"):
        tpa.ragged_prefill_attention(q, kv, kv, cache, cache, d, d, d, d, 0,
                                     block_q=16, rope_theta=THETA)
    cache = torch.zeros((1, 2, 64, 2, 16))
    with pytest.raises(ValueError, match="multiples of block_q"):
        tpa.ragged_prefill_attention(q, kv, kv, cache, cache, d, d + 3, d,
                                     d, 0, block_q=16, rope_theta=THETA)
    meta = torch.zeros((32, 4, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.ragged_prefill_attention(
            meta, kv.to("meta"), kv.to("meta"), cache.to("meta"),
            cache.to("meta"), *(x.to("meta") for x in (d, d, d, d)), 0,
            block_q=16, rope_theta=THETA)


# -- model level -------------------------------------------------------------

def _weights(name, dtype, seed=0):
    jcfg = j_get_config(name, vocab_size=VOCAB)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              getattr(torch, dtype))
    return jcfg, get_config(name, vocab_size=VOCAB), jp, tp


def _history_cache(jcfg, cfg, jp, tp, dtype, s, rng):
    """History written by both packages' chunk path from zero: slot 0
    holds 32 tokens, slot 2 holds 16."""
    hist = {0: 32, 2: 16}
    tk = np.zeros((2, 32), np.int32)
    ln = np.array(list(hist.values()), np.int32)
    sl = np.array(list(hist), np.int32)
    for i, n in enumerate(ln):
        tk[i, :n] = rng.integers(1, VOCAB, size=n)
    jcache = jt.init_kv_cache(jcfg, 5, s, jnp.dtype(dtype))
    _, jcache = jt.chunk_prefill_into_cache(
        jcfg, jp, jnp.asarray(tk), jnp.asarray(ln), jnp.zeros((2,), jnp.int32),
        jcache, jnp.asarray(sl), kv_view=s)
    tcache = tt.init_kv_cache(cfg, 5, s, getattr(torch, dtype), device="cpu")
    tt.chunk_prefill_into_cache(
        cfg, tp, torch.from_numpy(tk), torch.from_numpy(ln),
        torch.zeros((2,), dtype=torch.int32), tcache, torch.from_numpy(sl))
    return jcache, tcache


def _close(got, want, tol, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        assert np.abs(got - want).max() < BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("path", ["chunk", "ragged"])
@pytest.mark.parametrize("name,dtype", [("tiny", "float32"),
                                        ("tiny-gemma", "float32"),
                                        ("tiny", "bfloat16")])
def test_tail_prefill_matches_jax_chunk_path(name, dtype, path):
    jcfg, cfg, jp, tp = _weights(name, dtype, seed=5)
    rng = np.random.default_rng(0)
    s = 128
    jcache, tcache = _history_cache(jcfg, cfg, jp, tp, dtype, s, rng)
    tails = {slot: rng.integers(1, VOCAB, size=n).tolist() for slot, _, n in ENTRIES}
    tk = np.zeros((4, 48), np.int32)
    ln = np.array([n for *_, n in ENTRIES], np.int32)
    st = np.array([st for _, st, _ in ENTRIES], np.int32)
    sl = np.array([slot for slot, *_ in ENTRIES], np.int32)
    for i, (slot, _, n) in enumerate(ENTRIES):
        tk[i, :n] = tails[slot]
    jlast, jcache = jt.chunk_prefill_into_cache(
        jcfg, jp, jnp.asarray(tk), jnp.asarray(ln), jnp.asarray(st), jcache,
        jnp.asarray(sl), kv_view=s)
    if path == "chunk":
        tlast, _ = tt.chunk_prefill_into_cache(
            cfg, tp, torch.from_numpy(tk), torch.from_numpy(ln),
            torch.from_numpy(st), tcache, torch.from_numpy(sl), kv_view=s)
    else:
        slot_of, start_of, qoff_of, _q, base_of, offs = tpa.plan_ragged_group(
            ENTRIES, 16, 112, scratch_slot=4)
        flat = np.zeros((112,), np.int32)
        sample_idx = np.zeros((4,), np.int64)
        for i, ((slot, _, n), off) in enumerate(zip(ENTRIES, offs)):
            flat[off:off + n] = tails[slot]
            sample_idx[i] = off + n - 1
        tlast, _ = tt.ragged_prefill_into_cache(
            cfg, tp, torch.from_numpy(flat),
            *(torch.from_numpy(x) for x in (slot_of, start_of, qoff_of, base_of)),
            torch.from_numpy(sample_idx), tcache, block_q=16)
    _close(tlast, jlast, 1e-4, dtype)
    if dtype == "float32":
        assert (tlast.numpy().argmax(-1) == np.asarray(jlast).argmax(-1)).all()
    for slot, start, n in ENTRIES:
        for key in ("k", "v"):
            _close(tcache[key][:, slot, :start + n],
                   np.asarray(jcache[key])[:, slot, :start + n], 1e-5, dtype)


@pytest.mark.parametrize("path", ["chunk", "ragged"])
def test_zero_starts_equal_prefill_into_cache(path):
    _, cfg, _, tp = _weights("tiny", "float32", seed=6)
    rng = np.random.default_rng(1)
    lens = [16, 9, 30]
    tk = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lens):
        tk[i, :n] = rng.integers(1, VOCAB, size=n)
    slots = np.array([2, 0, 1], np.int32)
    ref = tt.init_kv_cache(cfg, 4, 64, torch.float32, device="cpu")
    want, _ = tt.prefill_into_cache(cfg, tp, torch.from_numpy(tk),
                                    torch.tensor(lens), ref, torch.from_numpy(slots))
    cache = tt.init_kv_cache(cfg, 4, 64, torch.float32, device="cpu")
    if path == "chunk":
        got, _ = tt.chunk_prefill_into_cache(
            cfg, tp, torch.from_numpy(tk), torch.tensor(lens),
            torch.zeros((3,), dtype=torch.int32), cache, torch.from_numpy(slots))
    else:
        entries = [(int(sl), 0, n) for sl, n in zip(slots, lens)]
        slot_of, start_of, qoff_of, _q, base_of, offs = tpa.plan_ragged_group(
            entries, 16, 96, scratch_slot=3)
        flat = np.zeros((96,), np.int32)
        for (_, _, n), off, row in zip(entries, offs, tk):
            flat[off:off + n] = row[:n]
        got, _ = tt.ragged_prefill_into_cache(
            cfg, tp, torch.from_numpy(flat),
            *(torch.from_numpy(x) for x in (slot_of, start_of, qoff_of, base_of)),
            torch.tensor([o + n - 1 for o, n in zip(offs, lens)]),
            cache, block_q=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for r, n in enumerate(lens):
        np.testing.assert_allclose(cache["k"][:, slots[r], :n].numpy(),
                                   ref["k"][:, slots[r], :n].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_chunk_prefill_pad_past_the_cache_writes_nothing_real():
    """A padded tail that runs past max_seq: XLA drops those writes, the
    port rewrites the row's own history there — the cache below the tail
    stays exactly as it was and the tail rows match a run without pads."""
    _, cfg, _, tp = _weights("tiny", "float32", seed=7)
    s = 64
    cache = tt.init_kv_cache(cfg, 2, s, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for plane in ("k", "v"):
        cache[plane].normal_(generator=gen)
    before = {p: cache[p].clone() for p in ("k", "v")}
    toks = torch.randint(1, VOCAB, (1, 32), generator=gen)
    starts, lens = torch.tensor([48]), torch.tensor([16])
    tt.chunk_prefill_into_cache(cfg, tp, toks, lens, starts, cache,
                                torch.tensor([1]))
    exact = {p: before[p].clone() for p in ("k", "v")}
    tt.chunk_prefill_into_cache(cfg, tp, toks[:, :16], lens, starts, exact,
                                torch.tensor([1]))
    for plane in ("k", "v"):
        assert torch.equal(cache[plane][:, :, :48], before[plane][:, :, :48])
        torch.testing.assert_close(cache[plane], exact[plane])
