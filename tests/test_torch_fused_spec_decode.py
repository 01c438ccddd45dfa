"""Kernel 5 (the fused K-token verify layer) of the port, on the CPU: its
plain version against the JAX Pallas kernel in interpret mode and against T
sequential plain kernel-4 calls; the int4 splice against the JAX package's;
and ``spec_verify_into_cache`` against the JAX package's and against T
sequential port ``decode_step``s.

- Against JAX ``fused_spec_decode_layer`` (interpret mode, fp32, L 2, B 3,
  S 256, K 2, H 4, D 32, T 5, softcap 5): both read the same rope — the
  port's plain version is handed the JAX kernel's own sin/cos expression
  through ``rope=``, so ``torch.sin`` against ``jnp.sin`` is not under
  test.  Attention within 2e-5; quantized cache bytes EQUAL; value scales
  within one ulp (jitted XLA's ``amax * (1 / qmax)``, ROADMAP Queue 3 —
  the port divides), key scales within 1e-6 relative: the Pallas body
  ropes inside the kernel under XLA, whose f32 rope arithmetic rounds
  differently in the last bits, and a key row's amax carries that; for
  the same reason the raw f32 cache's appended keys are within 2e-5, its
  values equal.  Parked rows keep their cache bytes.
- Against T sequential plain kernel-4 calls (``fused_decode_plain``) in
  bf16 at S 512 with window None and 64, every form: attention and cache
  BITWISE — the property that keeps greedy streams identical with
  speculation on and off.
- ``splice_packed_rows`` bit-exact against the JAX package's at odd and
  even starts and widths, parked starts at S and bursts crossing S (the
  out-of-bounds bytes this port rewrites instead of dropping).
- ``spec_verify_into_cache``, fused and unfused, every form, on bridged
  ``tiny`` weights with row 0 at an odd start: against the JAX package's
  (logits within 2e-3; quantized cache values equal but for rope-ulp
  rounding flips, scales within 1e-5, raw within 2e-5) and against T
  sequential port ``decode_step``s (cache equal, argmax equal, logits
  within 2e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    fused_spec_decode_layer as j_spec,
)
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
from p2p_llm_tunnel_tpu_torch.ops import fused_spec_decode as fs

THETA = 10000.0
FORMS = [None, "int8", "int4"]
T = 5  # burst width under test: K = 4 proposals + the carry token


def _cache(rng, form, l, b, s, kh, d):
    """A random cache in ``form`` as numpy: raw f32, or int8 / packed int4
    bytes with random positive scales."""
    if form is None:
        return [rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
                for _ in range(2)] + [None, None]
    rows = s // 2 if form == "int4" else s
    lo = -128 if form == "int4" else -127
    vals = [rng.integers(lo, 128, (l, b, rows, kh, d)).astype(np.int8)
            for _ in range(2)]
    scales = [(rng.random((l, b, s, kh)) * 0.1 + 0.01).astype(np.float32)
              for _ in range(2)]
    return vals + scales


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_rope(pos, t, d):
    """The Pallas kernel's in-kernel rope table, [B, T, D/2], as torch."""
    lane = jnp.arange(d // 2, dtype=jnp.float32)
    freqs = 1.0 / (THETA ** (2.0 * lane / d))
    ang = (jnp.asarray(pos)[:, None] + jnp.arange(t)[None, :]).astype(
        jnp.float32)[..., None] * freqs
    return _t(jnp.sin(ang)), _t(jnp.cos(ang))


@pytest.mark.parametrize("positions", [[7, 100, 255], [8, 13, 300]])
@pytest.mark.parametrize("form", FORMS)
def test_spec_plain_matches_jax_interpret(form, positions):
    """[7, 100, 255]: a burst inside the view and one crossing it at 255;
    [8, 13, 300]: even and odd int4 starts and a parked row (300 >= S)."""
    l, b, s, kh, h, d = 2, 3, 256, 2, 4, 32
    rng = np.random.default_rng(1)
    cache = _cache(rng, form, l, b, s, kh, d)
    q = rng.standard_normal((b, T, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, T, kh, d)).astype(np.float32)
    vn = rng.standard_normal((b, T, kh, d)).astype(np.float32)
    pos = np.array(positions, np.int32)
    want = j_spec(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                  *[None if x is None else jnp.asarray(x) for x in cache],
                  jnp.asarray(pos), jnp.asarray(1), kv_view=s,
                  rope_theta=THETA, kv_quant=form, softcap=5.0, interpret=True)
    tc = [_t(x) for x in cache]
    got = fs.fused_spec_decode_layer(
        _t(q), _t(kn), _t(vn), *tc, _t(pos), 1, kv_view=s, rope_theta=THETA,
        kv_quant=form, softcap=5.0, rope=_jax_rope(pos, T, d))
    act = pos + T <= s  # rows whose whole burst is live
    np.testing.assert_allclose(got.numpy()[act], np.asarray(want[0])[act],
                               atol=2e-5, rtol=0)
    if form is None:
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(want[1]),
                                   atol=2e-5, rtol=0)
        np.testing.assert_array_equal(tc[1].numpy(), np.asarray(want[2]))
    else:
        for i in (0, 1):
            np.testing.assert_array_equal(tc[i].numpy(), np.asarray(want[1 + i]))
        # V scales: one ulp (the reciprocal); K scales also carry the rope's
        # last bits through the row's amax.
        np.testing.assert_array_max_ulp(tc[3].numpy(), np.asarray(want[4]),
                                        maxulp=1)
        np.testing.assert_allclose(tc[2].numpy(), np.asarray(want[3]),
                                   rtol=1e-6, atol=0)
    for i, x in enumerate(cache):  # the parked row's bytes
        if x is not None and not act[-1] and pos[-1] >= s:
            np.testing.assert_array_equal(tc[i].numpy()[:, -1], x[:, -1])


def _sequential(q, kn, vn, cache, pos, layer, rope, **kw):
    """T plain kernel-4 calls, each appending its token before the next."""
    out = []
    for i in range(q.shape[1]):
        out.append(fd.fused_decode_plain(
            q[:, i], kn[:, i], vn[:, i], *cache, pos + i, layer,
            rope=(rope[0][:, i], rope[1][:, i]), **kw))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("form", FORMS)
def test_spec_plain_bitwise_equals_sequential_kernel4_bf16(form, window):
    """S 512 (two 256-key spans): bursts straddling 256, crossing the view
    at 509, and a parked row — attention and cache BITWISE."""
    l, b, s, kh, h, d = 2, 4, 512, 2, 4, 32
    rng = np.random.default_rng(3)
    cache = [_t(x) for x in _cache(rng, form, l, b, s, kh, d)]
    if form is None:
        cache[:2] = [x.bfloat16() for x in cache[:2]]

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q, kn, vn = bf16(b, T, h, d), bf16(b, T, kh, d), bf16(b, T, kh, d)
    pos = torch.tensor([255, 300, 509, 512], dtype=torch.int32)
    rope = fs.burst_rope_rows(pos, T, d, THETA)
    kw = dict(kv_view=s, rope_theta=THETA, kv_quant=form, window=window)
    c1 = [None if x is None else x.clone() for x in cache]
    c2 = [None if x is None else x.clone() for x in cache]
    got = fs.fused_spec_decode_layer(q, kn, vn, *c1, pos, 1, rope=rope, **kw)
    want = _sequential(q, kn, vn, c2, pos, 1, rope, **kw)
    live = (pos[:, None] + torch.arange(T)[None, :]) < s
    assert torch.equal(got[live], want[live])
    for a, w in zip(c1, c2):
        assert a is None or torch.equal(a, w)


@pytest.mark.parametrize("starts,t", [
    ([3, 4, 30, 32], 5),   # odd / even starts, one crossing S, one parked
    ([3, 4, 28, 32], 4),   # even T; an even start near S reaching byte S/2
    ([1, 2, 31, 32], 1),
    ([0, 29, 27, 32], 2),
    ([28, 5, 9, 32], 5),   # even start S-4 with odd T: byte S/2 is past the end
])
def test_splice_packed_rows_matches_jax(starts, t):
    l, r, s, kh, d = 2, 4, 32, 2, 4
    rng = np.random.default_rng(sum(starts) + t)
    plane = rng.integers(-128, 128, (l, r, s // 2, kh, d)).astype(np.int8)
    vals = rng.integers(-7, 8, (r, t, kh, d)).astype(np.int8)
    st = np.array(starts, np.int32)
    slots = np.arange(r)
    want = jq.splice_packed_rows(jnp.asarray(plane), jnp.asarray(1),
                                 jnp.asarray(slots), jnp.asarray(st),
                                 jnp.asarray(vals))
    got = torch.from_numpy(plane.copy())
    tq.splice_packed_rows(got, 1, torch.from_numpy(slots), torch.from_numpy(st),
                          torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0], plane[0])  # other layer
    np.testing.assert_array_equal(got.numpy()[1, 3], plane[1, 3])  # parked at S


@pytest.fixture(scope="module")
def bridged():
    jp = jt.init_params(j_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                    torch.float32)


def _prefilled(bridged, form, b=3, s=256, lens=(7, 12, 250), t=4):
    """Both packages' caches after prefilling the same prompts, and a burst
    of ``t`` tokens; row 0 starts its burst at the odd position 7."""
    jp, tp = bridged
    rng = np.random.RandomState(0)
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(1, 200, size=n)
    burst = rng.randint(1, 200, size=(b, t)).astype(np.int32)
    jcfg = j_get_config("tiny")
    jc = jt.init_kv_cache(jcfg, b, s, jnp.float32, quant=form or False)
    _, jc = jt.prefill_into_cache(jcfg, jp, jnp.asarray(toks), jnp.array(lens),
                                  jc, jnp.arange(b))
    tcfg = get_config("tiny")
    tc = tt.init_kv_cache(tcfg, b, s, torch.float32, quant=form, device="cpu")
    tt.prefill_into_cache(tcfg, tp, torch.from_numpy(toks).long(),
                          torch.tensor(lens), tc, torch.arange(b))
    return jc, tc, burst, np.array(lens, np.int32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_spec_verify_matches_sequential_decode_steps(bridged, form, fused):
    _, tp = bridged
    cfg = dataclasses.replace(get_config("tiny"), fused_decode_layer=fused)
    _, base, burst, lens = _prefilled(bridged, form)
    pos = torch.from_numpy(lens)
    seq = {k: v.clone() for k, v in base.items()}
    seq_logits = torch.stack([
        tt.decode_step(cfg, tp, seq, torch.from_numpy(burst[:, i]).long(),
                       pos + i, kv_view=256)[0]
        for i in range(burst.shape[1])], dim=1)
    got = {k: v.clone() for k, v in base.items()}
    logits, _ = tt.spec_verify_into_cache(cfg, tp, torch.from_numpy(burst).long(),
                                          pos, got, kv_view=256)
    np.testing.assert_allclose(logits.numpy(), seq_logits.numpy(), atol=2e-3, rtol=0)
    assert torch.equal(logits.argmax(-1), seq_logits.argmax(-1))
    for key in got:
        assert torch.equal(got[key], seq[key]), key


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_spec_verify_matches_jax(bridged, form, fused):
    """The JAX package runs kernel 5 in interpret mode (``flash_interpret``)
    on the fused path and its chunk fallback otherwise, as the port does."""
    jp, tp = bridged
    jc, tc, burst, lens = _prefilled(bridged, form)
    jcfg = dataclasses.replace(j_get_config("tiny"), fused_decode_layer=fused,
                               flash_interpret=fused)
    want, jc = jt.spec_verify_into_cache(jcfg, jp, jnp.asarray(burst),
                                         jnp.asarray(lens), jc, kv_view=256)
    cfg = dataclasses.replace(get_config("tiny"), fused_decode_layer=fused)
    got, _ = tt.spec_verify_into_cache(cfg, tp, torch.from_numpy(burst).long(),
                                       torch.from_numpy(lens), tc, kv_view=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)
    for key in tc:
        g, w = tc[key].numpy(), np.asarray(jc[key])
        if form is None:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
        elif key.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            # Values equal but where the packages' rope ulps move a value
            # across a rounding midpoint: by one level, rarely.
            gv, wv = (np.asarray(jq.unpack_int4(jnp.asarray(x), axis=2))
                      if form == "int4" else x for x in (g, w))
            diff = np.abs(gv.astype(np.int16) - wv.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key


def test_spec_wrapper_refuses_bursts_the_kernel_has_no_block_for():
    assert fs.fits(128, 5, 4) is None and fs.fits(128, 9, 8) is None
    assert "72" in fs.fits(128, 10, 8)
    assert "shared memory" in fs.fits(256, 9, 8)
    assert fs.fits(48, 5, 4) is not None
