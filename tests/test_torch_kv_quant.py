"""KV-cache quantization (int8, packed int4) in the port against the JAX
package, on the CPU.

- The packing and the quantizers are held BIT-EXACT against the JAX
  package's eager functions on identical inputs: ``unpack_int4`` on all 256
  byte values, ``pack_int4`` on all 256 nibble pairs, ``_quant_kv`` /
  ``_quant_kv4`` on f32 and bf16 rows including exact rounding midpoints
  (both round half to even and divide ``x / scale`` in IEEE f32).
- The whole-byte write helpers leave the same planes as JAX's, parked and
  past-the-end rows included (XLA drops those writes; the port rewrites
  the old byte, so the planes agree).
- Model level (fp32 ``tiny`` on bridged weights): logits within the fp32
  tolerance of tests/test_torch_transformer.py (1e-4).  Cache values may
  differ where the two packages' K/V (different matmul summation order)
  straddle a rounding midpoint: at most 0.1% of the values, by at most one
  level; scales within 1e-5 relative (the same summation-order noise, and
  jitted XLA computes ``amax / qmax`` as ``amax * (1 / qmax)``, one ulp
  off an IEEE division).
- Kernel 2's and kernel 6's plain versions against the JAX Pallas kernels
  in interpret mode, fp32: attention 1e-5 (kernel 2) and 2e-4 (kernel 6,
  tests/test_torch_ragged_prefill.py's); kernel 6's appended bytes with
  the same one-level allowance (its rope goes through ``torch.sin`` vs
  ``jnp.sin``, which may differ in the last ulp) and scales within 1e-6
  relative.  Also at odd decode positions (the high int4 nibble) with a
  window, a soft cap and a parked row, and for ragged tails that start
  mid-page, in every cache form.
- The prefix pool's packed pages and copies equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine import prefix_cache as jpc
from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    flash_decode_attention_sgrid_int4 as j_sgrid_int4,
    flash_decode_attention_sgrid_int8 as j_sgrid_int8,
    page_alignment_violations as j_violations,
)
from p2p_llm_tunnel_tpu.ops.pallas_prefill_attention import (
    ragged_prefill_attention as j_ragged,
)
from p2p_llm_tunnel_tpu_torch.engine import prefix_cache as tpc
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import decode_attention as tda
from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as tpa

VOCAB = 300
THETA = 10000.0
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_transformer.py fp32
SCALE_RTOL = 1e-5
BYTE_FRAC = 1e-3  # values allowed one level apart (summation-order noise)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _values(plane, packed, axis):
    """int8 cache values (unpacked along ``axis`` when packed) as int16."""
    vals = np.asarray(plane)
    if packed:
        vals = np.asarray(jq.unpack_int4(jnp.asarray(vals), axis=axis))
    return vals.astype(np.int16)


def _assert_values_close(got, want, packed, axis, frac=BYTE_FRAC):
    g = _values(got, packed, axis)
    w = _values(want, packed, axis)
    diff = np.abs(g - w)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= frac, (diff > 0).mean()


def _jquant(x, mode):
    """JAX-eager quantization of cache rows ``x`` (sequence axis 1 of the
    last four) in ``mode``: (values/packed bytes, scales) as numpy."""
    q, s = (jt._quant_kv4 if mode == "int4" else jt._quant_kv)(jnp.asarray(x))
    if mode == "int4":
        q = jq.pack_int4(q, axis=x.ndim - 3)
    return np.asarray(q), np.asarray(s)


# ---------------------------------------------------------------------------
# packing and quantizers, bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_unpack_int4_all_256_bytes_match_jax(axis):
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = tq.unpack_int4(torch.from_numpy(b), axis=axis).numpy()
    want = np.asarray(jq.unpack_int4(jnp.asarray(b), axis=axis))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and got.min() == -8 and got.max() == 7


def test_pack_int4_all_nibble_pairs_match_jax_and_roundtrip():
    pairs = np.array([(lo, hi) for lo in range(-8, 8) for hi in range(-8, 8)],
                     np.int8)  # [256, 2]: element 0 low nibble, 1 high
    got = tq.pack_int4(torch.from_numpy(pairs), axis=1).numpy()
    want = np.asarray(jq.pack_int4(jnp.asarray(pairs), axis=1))
    np.testing.assert_array_equal(got, want)
    assert sorted(got[:, 0].tolist()) == list(range(-128, 128))
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(got), axis=1).numpy(), pairs)


def _rows(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 3, 32)) * 2.5).astype(np.float32)
    # Exact rounding midpoints: scale 1 (int4: amax 7; int8: amax 127).
    x[0, 0, :4] = [7.0, 3.5, -2.5, 0.5]
    x[0, 0, 4:] = 0.0
    x[0, 1, :4] = [127.0, 62.5, -1.5, 0.5]
    x[0, 1, 4:] = 0.0
    x[1] = 0.0  # all-zero rows: the 1e-8 scale floor
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantizers_bit_exact_against_jax(mode, dtype):
    x = _rows(dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tf = tt._quant_kv4 if mode == "int4" else tt._quant_kv
    jf = jt._quant_kv4 if mode == "int4" else jt._quant_kv
    q, s = tf(torch.from_numpy(x).to(tdt))
    jq_, js = jf(jnp.asarray(x, jdt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    if mode == "int4":  # half to even: 3.5 -> 4, -2.5 -> -2, 0.5 -> 0
        assert q[0, 0, :4].tolist() == [7, 4, -2, 0]


def test_quantize_act_bit_exact_against_jax():
    x = _rows("float32")
    q, s = tq._quantize_act(torch.from_numpy(x))
    jq_, js = jq._quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# whole-byte packed writes
# ---------------------------------------------------------------------------

def _plane(rng, l=2, b=3, nbytes=8, kh=2, d=4):
    return rng.integers(-128, 128, (l, b, nbytes, kh, d)).astype(np.int8)


def _vals(rng, *shape):
    return rng.integers(-7, 8, shape).astype(np.int8)


def test_write_packed_prefix_matches_jax():
    rng = np.random.default_rng(0)
    plane, vals = _plane(rng), _vals(rng, 2, 2, 6, 2, 4)
    slots = np.array([2, 0], np.int32)
    want = jq.write_packed_prefix(jnp.asarray(plane), jnp.asarray(slots),
                                  jnp.asarray(vals))
    got = tq.write_packed_prefix(_t(plane), _t(slots), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_packed_chunk_matches_jax_past_the_end():
    """Byte rows past the plane (a tail padded beyond max_seq) are dropped
    by XLA and rewritten with their old byte by the port: same plane."""
    rng = np.random.default_rng(1)
    plane, vals = _plane(rng), _vals(rng, 2, 6, 2, 4)
    starts = np.array([2, 12], np.int32)  # row 1's last two bytes overflow
    rows = np.array([[1], [2]], np.int32)
    bpos = starts[:, None] // 2 + np.arange(3)[None, :]
    want = jq.write_packed_chunk(jnp.asarray(plane), 1, jnp.asarray(rows),
                                 jnp.asarray(bpos), jnp.asarray(vals))
    got = tq.write_packed_chunk(_t(plane), 1, _t(rows), _t(bpos), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_append_packed_token_matches_jax_parked_and_both_parities():
    rng = np.random.default_rng(2)
    plane, vals = _plane(rng, b=4), _vals(rng, 4, 2, 4)
    positions = np.array([0, 5, 14, 16], np.int32)  # even, odd, last, parked
    slots = np.arange(4, dtype=np.int32)
    want = jq.append_packed_token(jnp.asarray(plane), 1, jnp.asarray(slots),
                                  jnp.asarray(positions), jnp.asarray(vals))
    got = tq.append_packed_token(_t(plane), 1, _t(slots), _t(positions), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1, 3], plane[1, 3])  # parked


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, "none", True, "int8", "int4"])
def test_init_kv_cache_layout_matches_jax(quant):
    jcfg = j_get_config("tiny", vocab_size=VOCAB)
    cfg = get_config("tiny", vocab_size=VOCAB)
    want = jt.init_kv_cache(jcfg, 3, 64, jnp.float32, quant=quant)
    got = tt.init_kv_cache(cfg, 3, 64, torch.float32, quant=quant, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    assert tt.kv_cache_quant_mode(got) == jt.kv_cache_quant_mode(want)
    assert tt.kv_cache_is_quantized(got) == jt.kv_cache_is_quantized(want)


def test_init_kv_cache_refuses_what_jax_refuses():
    cfg = get_config("tiny", vocab_size=VOCAB)
    jcfg = j_get_config("tiny", vocab_size=VOCAB)
    for kw in (dict(max_seq=63, quant="int4"), dict(max_seq=64, quant="int2")):
        with pytest.raises(ValueError):
            tt.init_kv_cache(cfg, 2, device="cpu", **kw)
        with pytest.raises(ValueError):
            jt.init_kv_cache(jcfg, 2, **kw)


def _models():
    jcfg = j_get_config("tiny", vocab_size=VOCAB)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return jcfg, get_config("tiny", vocab_size=VOCAB), jp, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _caches(jcfg, cfg, mode, slots=3, s=128):
    return (jt.init_kv_cache(jcfg, slots, s, jnp.float32, quant=mode),
            tt.init_kv_cache(cfg, slots, s, torch.float32, quant=mode, device="cpu"))


def _assert_cache_close(tc, jc, mode):
    for plane in ("k", "v"):
        _assert_values_close(tc[plane].numpy(), jc[plane], mode == "int4", 2)
    for sc in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[sc].numpy(), np.asarray(jc[sc]),
                                   rtol=SCALE_RTOL, atol=0)


def _prefill_both(models, mode, t, seed=3):
    jcfg, cfg, jp, tp = models
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (2, t)).astype(np.int32)
    lens = np.array([t, max(1, t - 13)], np.int32)
    slots = np.array([0, 2], np.int32)
    jc, tc = _caches(jcfg, cfg, mode)
    jl, jc = jt.prefill_into_cache(jcfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                                   jc, jnp.asarray(slots))
    tl, tc = tt.prefill_into_cache(cfg, tp, _t(toks).long(), _t(lens).long(), tc,
                                   _t(slots).long())
    return (jl, jc), (tl, tc), rng


@pytest.mark.parametrize("t", [32, 33])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prefill_into_cache_quantized_matches_jax(models, mode, t):
    """t=33 under int4: the odd width pads one zero position so the packed
    write covers whole bytes, as the reference does."""
    (jl, jc), (tl, tc), _ = _prefill_both(models, mode, t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache_close(tc, jc, mode)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_chunk_prefill_quantized_matches_jax(models, mode):
    jcfg, cfg, jp, tp = models
    (_, jc), (_, tc), rng = _prefill_both(models, mode, 33)
    tail = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    starts = np.array([34, 20], np.int32)
    slots = np.array([0, 2], np.int32)
    jl, jc = jt.chunk_prefill_into_cache(
        jcfg, jp, jnp.asarray(tail), jnp.asarray(lens), jnp.asarray(starts), jc,
        jnp.asarray(slots), kv_view=128)
    tl, tc = tt.chunk_prefill_into_cache(
        cfg, tp, _t(tail).long(), _t(lens).long(), _t(starts).long(), tc,
        _t(slots).long(), kv_view=128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache_close(tc, jc, mode)


def test_chunk_prefill_int4_refuses_odd_widths(models):
    _, cfg, _, tp = models
    cache = tt.init_kv_cache(cfg, 2, 64, torch.float32, quant="int4", device="cpu")
    with pytest.raises(ValueError, match="even"):
        tt.chunk_prefill_into_cache(
            cfg, tp, torch.zeros((1, 15), dtype=torch.long),
            torch.tensor([15]), torch.tensor([16]), cache, torch.tensor([0]))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_step_quantized_matches_jax(models, mode):
    """Three unfused decode steps (kernel 2's plain form) with a parked row
    at max_seq: XLA drops its writes, the port keeps its old row."""
    jcfg, cfg, jp, tp = models
    (_, jc), (_, tc), _ = _prefill_both(models, mode, 33)
    toks = np.array([5, 7, 9], np.int32)
    pos = np.array([33, 128, 20], np.int32)
    for _ in range(3):
        jl, jc = jt.decode_step(jcfg, jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                                kv_view=64)
        tl, tc = tt.decode_step(cfg, tp, tc, _t(toks), _t(pos), kv_view=64)
        live = pos < 128
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        pos = np.where(live, pos + 1, pos)
    _assert_cache_close(tc, jc, mode)


# ---------------------------------------------------------------------------
# kernel 2 and kernel 6 plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(window=50, softcap=30.0)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_kernel_plain_matches_jax_interpret(mode, kw):
    rng = np.random.default_rng(1)
    b, s, kh, g, d = 3, 256, 2, 2, 32
    q = rng.standard_normal((b, 1, kh * g, d)).astype(np.float32)
    kc, ks = _jquant(rng.standard_normal((b, s, kh, d)).astype(np.float32), mode)
    vc, vs = _jquant(rng.standard_normal((b, s, kh, d)).astype(np.float32), mode)
    pos = np.array([0, 130, 255], np.int32)
    jfn = j_sgrid_int4 if mode == "int4" else j_sgrid_int8
    want = jfn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
               jnp.asarray(vs), jnp.asarray(pos), interpret=True, **kw)
    got = tda.flash_decode_attention(_t(q), _t(kc), _t(vc), _t(pos),
                                     k_scale=_t(ks), v_scale=_t(vs),
                                     kv_quant=mode, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_decode_kernel_form_arguments_are_checked():
    q = torch.zeros((1, 1, 2, 16))
    kc = torch.zeros((1, 8, 1, 16), dtype=torch.int8)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_quant"):
        tda.flash_decode_attention(q, kc, kc, pos, kv_quant="int8")
    with pytest.raises(ValueError, match="together"):
        tda.flash_decode_attention(q, kc, kc, pos, k_scale=torch.ones(1, 8, 1))
    assert tda.page_alignment_violations("int4", 15, 33) == j_violations("int4", 15, 33)
    assert tda.page_alignment_violations("int8", 15, 33) == []


ENTRIES = [(0, 32, 20), (1, 0, 7), (2, 16, 33)]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_ragged_kernel_plain_matches_jax_interpret(mode):
    rng = np.random.default_rng(2)
    l, b, s, kh, g, d, tot, bq = 2, 4, 128, 2, 2, 32, 128, 16
    h = kh * g
    plan = tpa.plan_ragged_group(ENTRIES, bq, tot, scratch_slot=3)
    kc, ks = _jquant(rng.standard_normal((l, b, s, kh, d)).astype(np.float32), mode)
    vc, vs = _jquant(rng.standard_normal((l, b, s, kh, d)).astype(np.float32), mode)
    q = np.zeros((tot, h, d), np.float32)
    kn = np.zeros((tot, kh, d), np.float32)
    vn = np.zeros((tot, kh, d), np.float32)
    for (_slot, _start, ln), off in zip(ENTRIES, plan[5]):
        q[off:off + ln] = rng.standard_normal((ln, h, d))
        kn[off:off + ln] = rng.standard_normal((ln, kh, d))
        vn[off:off + ln] = rng.standard_normal((ln, kh, d))
    descs = [np.asarray(x) for x in (plan[0], plan[1], plan[2], plan[4])]
    want = j_ragged(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                    jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
                    jnp.asarray(vs), *[jnp.asarray(x) for x in descs],
                    jnp.asarray(1), block_q=bq, rope_theta=THETA,
                    kv_quant=mode, interpret=True)
    tk, tv, tks, tvs = _t(kc), _t(vc), _t(ks), _t(vs)
    got = tpa.ragged_prefill_attention(
        _t(q), _t(kn), _t(vn), tk, tv, *[_t(x) for x in descs], 1,
        k_scale=tks, v_scale=tvs, kv_quant=mode, block_q=bq, rope_theta=THETA)
    real = np.concatenate([np.arange(o, o + ln)
                           for (_, _, ln), o in zip(ENTRIES, plan[5])])
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want[0])[real],
                               atol=2e-4, rtol=2e-4)
    # Real slots only (slot 3 is the pad blocks' scratch row).
    for plane, w in ((tk, want[1]), (tv, want[2])):
        _assert_values_close(plane.numpy()[:, :3], np.asarray(w)[:, :3],
                             mode == "int4", 2, frac=1e-3)
    for sc, w in ((tks, want[3]), (tvs, want[4])):
        np.testing.assert_allclose(sc.numpy()[:, :3], np.asarray(w)[:, :3],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("positions", [[1, 63, 129, 255], [3, 65, 201, 281]])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_plain_odd_positions_match_jax_interpret(mode, positions):
    """Odd positions (the high nibble of an int4 byte is the frontier), a
    window that cuts the history, a soft cap, and a parked row (pos 281 >
    S 256: the view's keys within the window, 242-255)."""
    rng = np.random.default_rng(11)
    b, s, kh, g, d = 4, 256, 2, 4, 16
    kw = dict(window=40, softcap=25.0)
    q = rng.standard_normal((b, 1, kh * g, d)).astype(np.float32)
    kc, ks = _jquant(rng.standard_normal((b, s, kh, d)).astype(np.float32), mode)
    vc, vs = _jquant(rng.standard_normal((b, s, kh, d)).astype(np.float32), mode)
    pos = np.array(positions, np.int32)
    jfn = j_sgrid_int4 if mode == "int4" else j_sgrid_int8
    want = jfn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
               jnp.asarray(vs), jnp.asarray(pos), interpret=True, **kw)
    got = tda.flash_decode_attention(_t(q), _t(kc), _t(vc), _t(pos),
                                     k_scale=_t(ks), v_scale=_t(vs),
                                     kv_quant=mode, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


#: Tails that start mid-page (a 32- and a 64-token page hold 16 and 48
#: history tokens), cross q-block edges and end mid-block.
MID_PAGE = [(0, 48, 29), (1, 16, 40), (2, 80, 3)]


@pytest.mark.parametrize("kw", [dict(), dict(window=20, softcap=15.0)])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_ragged_plain_mid_page_tails_match_jax_interpret(mode, kw):
    """Kernel 6's plain version against the Pallas kernel (interpret, fp32)
    in each cache form: attention 2e-4, written rows (raw 1e-6; quantized
    values one level apart at most, scales 1e-6 relative), and the
    histories as given."""
    rng = np.random.default_rng(7)
    l, b, s, kh, g, d, tot, bq = 2, 4, 128, 2, 3, 32, 128, 16
    h = kh * g
    plan = tpa.plan_ragged_group(MID_PAGE, bq, tot, scratch_slot=3)
    kf = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    vf = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    if mode is None:
        (kc, ks), (vc, vs) = (kf, None), (vf, None)
    else:
        (kc, ks), (vc, vs) = _jquant(kf, mode), _jquant(vf, mode)
    q = np.zeros((tot, h, d), np.float32)
    kn = np.zeros((tot, kh, d), np.float32)
    vn = np.zeros((tot, kh, d), np.float32)
    for (_slot, _start, ln), off in zip(MID_PAGE, plan[5]):
        q[off:off + ln] = rng.standard_normal((ln, h, d))
        kn[off:off + ln] = rng.standard_normal((ln, kh, d))
        vn[off:off + ln] = rng.standard_normal((ln, kh, d))
    descs = [np.asarray(x) for x in (plan[0], plan[1], plan[2], plan[4])]
    qkw = {} if mode is None else dict(kv_quant=mode)
    want = j_ragged(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                    jnp.asarray(kc), jnp.asarray(vc),
                    None if ks is None else jnp.asarray(ks),
                    None if vs is None else jnp.asarray(vs),
                    *[jnp.asarray(x) for x in descs], jnp.asarray(1),
                    block_q=bq, rope_theta=THETA, interpret=True, **qkw, **kw)
    tk, tv, tks, tvs = _t(kc), _t(vc), _t(ks), _t(vs)
    got = tpa.ragged_prefill_attention(
        _t(q), _t(kn), _t(vn), tk, tv, *[_t(x) for x in descs], 1,
        k_scale=tks, v_scale=tvs, block_q=bq, rope_theta=THETA, **qkw, **kw)
    real = np.concatenate([np.arange(o, o + ln)
                           for (_, _, ln), o in zip(MID_PAGE, plan[5])])
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want[0])[real],
                               atol=2e-4, rtol=2e-4)
    for slot, start, ln in MID_PAGE:
        for plane, w, orig in ((tk, want[1], kc), (tv, want[2], vc)):
            rows = slice(start // 2, (start + ln + 1) // 2) if mode == "int4" \
                else slice(start, start + ln)
            hist = slice(0, start // 2 if mode == "int4" else start)
            if mode is None:
                np.testing.assert_allclose(plane.numpy()[1, slot, rows],
                                           np.asarray(w)[1, slot, rows],
                                           rtol=1e-6, atol=1e-6)
            else:
                _assert_values_close(plane.numpy()[1, slot, rows][None],
                                     np.asarray(w)[1, slot, rows][None],
                                     mode == "int4", 1, frac=1e-3)
            np.testing.assert_array_equal(plane.numpy()[1, slot, hist],
                                          orig[1, slot, hist])
        if mode is not None:
            for sc, w in ((tks, want[3]), (tvs, want[4])):
                np.testing.assert_allclose(sc.numpy()[1, slot, start:start + ln],
                                           np.asarray(w)[1, slot, start:start + ln],
                                           rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tk.numpy()[0], kc[0])


def test_ragged_int4_refuses_odd_block_q():
    cache = torch.zeros((1, 2, 8, 1, 16), dtype=torch.int8)
    sc = torch.zeros((1, 2, 16, 1))
    descs = [torch.zeros(2, dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match="even block_q"):
        tpa.ragged_prefill_attention(
            torch.zeros((6, 2, 16)), torch.zeros((6, 1, 16)),
            torch.zeros((6, 1, 16)), cache, cache.clone(), *descs, 0,
            k_scale=sc, v_scale=sc.clone(), kv_quant="int4", block_q=3,
            rope_theta=THETA)


# ---------------------------------------------------------------------------
# the prefix pool over quantized caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_pool_pages_and_copies_match_jax(mode):
    """Packed int4 value leaves move in block // 2-byte pages; scale planes
    and int8 planes in block-position pages — both copies equal JAX's."""
    jcfg = j_get_config("tiny", vocab_size=VOCAB)
    cfg = get_config("tiny", vocab_size=VOCAB)
    block, max_blocks, rows, cap = 8, 4, 2, 6
    rng = np.random.default_rng(4)
    jc = jt.init_kv_cache(jcfg, 3, 32, jnp.float32, quant=mode)
    cache = {k: rng.integers(-100, 100, v.shape).astype(np.asarray(v).dtype)
             for k, v in jc.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    packed = tpc.pool_packed_keys(tcache)
    assert packed == jpc.pool_packed_keys(jc)
    jpool = jpc.init_pool(jc, block, cap)
    tpool = tpc.init_pool(tt.init_kv_cache(cfg, 3, 32, torch.float32, quant=mode,
                                           device="cpu"), block, cap)
    assert {k: tuple(v.shape) for k, v in tpool.items()} == {
        k: tuple(v.shape) for k, v in jpool.items()}
    pool = {k: rng.integers(-100, 100, v.shape).astype(np.asarray(v).dtype)
            for k, v in jpool.items()}
    j_in, j_out = jpc.make_batch_copy_ops(block, max_blocks, rows, packed_keys=packed)
    t_in, t_out = tpc.make_batch_copy_ops(block, max_blocks, rows, packed_keys=packed)
    slots = np.array([2, 0], np.int32)
    pids = np.array([[1, 2, 3, 3], [4, 5, 5, 5]], np.int32)
    bnos = np.array([[0, 1, 2, 2], [1, 2, 2, 2]], np.int32)
    want = j_in({k: jnp.asarray(v) for k, v in cache.items()},
                {k: jnp.asarray(v) for k, v in pool.items()},
                jnp.asarray(slots), jnp.asarray(pids), jnp.asarray(bnos))
    got = t_in({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
               {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
               slots, pids, bnos)
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    out_ids = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    want = j_out({k: jnp.asarray(v) for k, v in pool.items()},
                 {k: jnp.asarray(v) for k, v in cache.items()},
                 jnp.asarray(slots), jnp.asarray(out_ids), jnp.asarray(bnos))
    got = t_out({k: torch.from_numpy(v.copy()) for k, v in pool.items()},
                tcache, slots, out_ids, bnos)
    for k in pool:
        np.testing.assert_array_equal(got[k].numpy()[:, 1:], np.asarray(want[k])[:, 1:])


# ---------------------------------------------------------------------------
# the engine's int4 page-alignment pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=33),  # an odd segment width rounds up to even
    dict(min_prefill_bucket=15, prefill_chunk=30, prefix_cache=True,
         conv_cache=True),  # an odd pool page fences the prefix cache
])
def test_int4_page_alignment_pass_matches_jax(kw):
    from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
    from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
    from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine

    base = dict(model="tiny", num_slots=2, max_seq=128, dtype="float32",
                kv_quant="int4", **kw)
    want = JInferenceEngine(engine_cfg=JEngineConfig(**base))
    got = InferenceEngine(engine_cfg=EngineConfig(**base), device="cpu")
    assert got.ecfg.prefill_chunk == want.ecfg.prefill_chunk
    assert got.ecfg.prefix_cache == want.ecfg.prefix_cache
    assert got.config_fences == want.config_fences
    assert tt.kv_cache_quant_mode(got.kv_cache) == "int4"
