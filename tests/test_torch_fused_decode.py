"""Kernel 4 (the fused decode layer) of the port, on the CPU: its plain
version against the JAX Pallas kernel in interpret mode and against a
composed reference, and the fused decode step against the unfused one.

- Against JAX ``fused_decode_layer`` (interpret mode, fp32, a handful of
  cases): attention within 1e-5; quantized cache values equal except where
  the two packages' rope (``torch.sin`` vs ``jnp.sin``, last-ulp
  differences) moves a value across a rounding midpoint — at most 2% of the
  appended values, by at most one level; scales within 1e-6 relative (the
  same rope noise, and jitted XLA's ``amax * (1 / qmax)``); the raw f32
  cache's appended rows within 1e-5 (rope ulps).  Parked rows keep their
  cache row and scales exactly; an int4 append keeps its neighbour's nibble.
- Against a composed reference — ``ops/rope.apply_rope`` in f32, the
  model's quantizers, the model's append helpers, f32 dequantization and
  ``ops/attention.cached_attention`` — at every KV form, with window and
  softcap, at one and two 256-key spans: attention within 1e-5 (the
  kernel folds the new row last and pre-scales q; fp32 reassociation), the
  cache bit-exact.
- ``decode_step`` with the fused layer against the unfused step on the
  ``tiny`` model, fp32: greedy tokens identical and logits within 1e-4 at
  every KV form.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    fused_decode_layer as j_fused,
)
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
from p2p_llm_tunnel_tpu_torch.ops.attention import cached_attention
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import dequant_f32
from p2p_llm_tunnel_tpu_torch.ops.rope import apply_rope

THETA = 10000.0
FORMS = [None, "int8", "int4"]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(form, s, b=4, l=2, kh=2, g=2, d=32, seed=0):
    """Random pre-rope q / new rows and a random cache in ``form`` (JAX's
    eager quantizers), as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    kn = rng.standard_normal((b, kh, d)).astype(np.float32)
    vn = rng.standard_normal((b, kh, d)).astype(np.float32)
    hk = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    hv = rng.standard_normal((l, b, s, kh, d)).astype(np.float32)
    if form is None:
        return q, kn, vn, [hk, hv, None, None]
    qf = jt._quant_kv4 if form == "int4" else jt._quant_kv
    kc, ks = qf(jnp.asarray(hk))
    vc, vs = qf(jnp.asarray(hv))
    if form == "int4":
        kc, vc = jq.pack_int4(kc, axis=2), jq.pack_int4(vc, axis=2)
    return q, kn, vn, [np.asarray(x) for x in (kc, vc, ks, vs)]


def _values(plane, form):
    v = np.asarray(plane)
    if form == "int4":
        v = np.asarray(jq.unpack_int4(jnp.asarray(v), axis=2))
    return v.astype(np.int16)


@pytest.mark.parametrize("form,kw", [
    (None, {}), ("int8", {}), ("int4", {}),
    ("int4", dict(window=64, softcap=20.0)),
])
def test_fused_plain_matches_jax_interpret(form, kw):
    s, layer = 256, 1
    q, kn, vn, cache = _inputs(form, s)
    pos = np.array([0, 101, 255, 300], np.int32)  # 300: parked (>= view)
    want = j_fused(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                   *[None if x is None else jnp.asarray(x) for x in cache],
                   jnp.asarray(pos), jnp.asarray(layer), kv_view=s,
                   rope_theta=THETA, kv_quant=form, interpret=True, **kw)
    tc = [_t(x) for x in cache]
    got = fd.fused_decode_layer(_t(q), _t(kn), _t(vn), *tc, _t(pos), layer,
                                kv_view=s, rope_theta=THETA, kv_quant=form, **kw)
    live = pos < s
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want[0])[live],
                               atol=1e-5, rtol=1e-5)
    for i in (0, 1):  # k, v planes
        g, w = tc[i].numpy(), np.asarray(want[1 + i])
        if form is None:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
            continue
        diff = np.abs(_values(g, form) - _values(w, form))
        assert diff.max() <= 1
        assert diff.sum() <= 0.02 * live.sum() * g.shape[3] * g.shape[4]
        np.testing.assert_array_equal(g[:, 3], cache[i][:, 3])  # parked slot
    if form is not None:
        for i in (2, 3):
            np.testing.assert_allclose(tc[i].numpy(), np.asarray(want[1 + i]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_array_equal(tc[i].numpy()[:, 3], cache[i][:, 3])


def _reference(form, q, kn, vn, cache, pos, layer, view, **kw):
    """rope -> quantize -> append (the model's helpers) -> dequantize ->
    cached_attention over the cache view, on torch tensors (f32); updates
    ``cache`` in place, leaves parked rows alone."""
    b = q.shape[0]
    live = pos.long() < view
    qr = apply_rope(q[:, None], pos[:, None], THETA)[:, 0]
    kr = apply_rope(kn[:, None], pos[:, None], THETA)[:, 0]
    kc, vc, ks, vs = cache
    slots = torch.arange(b)[live]
    at = pos.long()[live]
    if form is None:
        kc[layer, slots, at] = kr[live]
        vc[layer, slots, at] = vn[live]
        kd, vd = kc[layer, :, :view], vc[layer, :, :view]
    else:
        qf = tt._quant_kv4 if form == "int4" else tt._quant_kv
        for plane, scales, x in ((kc, ks, kr), (vc, vs, vn)):
            vals, sc = qf(x)
            scales[layer, slots, at] = sc[live]
            if form == "int4":
                tq.append_packed_token(plane, layer, slots, at, vals[live])
            else:
                plane[layer, slots, at] = vals[live]
        rows = view // 2 if form == "int4" else view
        kd = dequant_f32(kc[layer, :, :rows], ks[layer, :, :view], form)
        vd = dequant_f32(vc[layer, :, :rows], vs[layer, :, :view], form)
    return cached_attention(qr[:, None], kd, vd, pos, **kw)[:, 0]


@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("kw", [dict(), dict(window=64), dict(softcap=20.0)])
@pytest.mark.parametrize("form", FORMS)
def test_fused_plain_matches_composed_reference(form, kw, s):
    """s=512: positions in both 256-key spans, the append past the first."""
    layer = 1
    q, kn, vn, cache = _inputs(form, s, seed=1)
    pos = torch.tensor([0, 101, s - 1, 321 if s == 512 else 200], dtype=torch.int32)
    c1 = [_t(x) for x in cache]
    c2 = [_t(x) for x in cache]
    got = fd.fused_decode_layer(_t(q), _t(kn), _t(vn), *c1, pos, layer,
                                kv_view=s, rope_theta=THETA, kv_quant=form, **kw)
    want = _reference(form, _t(q), _t(kn), _t(vn), c2, pos, layer, s, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    for a, w in zip(c1, c2):
        if a is not None:
            assert torch.equal(a, w)


@pytest.mark.parametrize("form", FORMS)
def test_fused_append_keeps_parked_rows_and_neighbour_nibbles(form):
    """Only the live slots' own rows change (their scale too); a parked row
    (pos >= view, view < S) keeps its row and scales; for int4 the byte
    shared with the neighbouring token keeps the neighbour's nibble."""
    s, view, layer = 512, 256, 0
    q, kn, vn, cache = _inputs(form, s, b=5, seed=2)
    pos = torch.tensor([7, 8, 255, 256, 400], dtype=torch.int32)  # last two parked
    c = [_t(x) for x in cache]
    fd.fused_decode_layer(_t(q), _t(kn), _t(vn), *c, pos, layer, kv_view=view,
                          rope_theta=THETA, kv_quant=form)
    for i, (a, o) in enumerate(zip(c, cache)):
        if a is None:
            continue
        changed = a.numpy() != o
        for slot, p in enumerate(pos.tolist()):
            if p < view:
                row = p // 2 if (form == "int4" and i < 2) else p
                assert changed[layer, slot, row].any() or i >= 2 or form is None
                changed[layer, slot, row] = False
        assert not changed.any()
        if form == "int4" and i < 2:
            for slot, p in enumerate(pos.tolist()[:3]):
                new_b = a.numpy()[layer, slot, p // 2].astype(np.int16) & 0xFF
                old_b = o[layer, slot, p // 2].astype(np.int16) & 0xFF
                keep = 0x0F if p % 2 else 0xF0
                np.testing.assert_array_equal(new_b & keep, old_b & keep)


def test_fused_wrapper_checks_its_form_arguments():
    q = torch.zeros((1, 2, 16))
    kn = torch.zeros((1, 1, 16))
    cache = torch.zeros((1, 1, 8, 1, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="kv_quant"):
        fd.fused_decode_layer(q, kn, kn, cache, cache, None, None,
                              torch.zeros(1, dtype=torch.int32), 0, kv_view=8,
                              rope_theta=THETA, kv_quant="int4")


@pytest.mark.parametrize("form", FORMS)
def test_decode_step_fused_matches_unfused_greedy(form):
    """The fused and the unfused decode step stream the same greedy tokens
    on the tiny model (the JAX package pins the same identity for its own
    pair: tests/test_fused_decode_layer.py)."""
    cfg = get_config("tiny", vocab_size=300)
    params = tt.init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 300, (3, 21)))
    lens = torch.tensor([21, 12, 5])
    base = tt.init_kv_cache(cfg, 4, 128, torch.float32, quant=form, device="cpu")
    last, _ = tt.prefill_into_cache(cfg, params, toks, lens, base,
                                    torch.tensor([0, 1, 2]))
    first = torch.cat([last.argmax(-1), torch.zeros(1, dtype=torch.long)])
    streams, logits_of = {}, {}
    for fused in (False, True):
        mcfg = dataclasses.replace(cfg, fused_decode_layer=fused)
        cache = {k: v.clone() for k, v in base.items()}
        tok = first.clone()
        pos = torch.tensor([21, 12, 5, 128], dtype=torch.int32)  # slot 3 parked
        out, lgs = [], []
        for _ in range(8):
            logits, _ = tt.decode_step(mcfg, params, cache, tok, pos, kv_view=64)
            tok = logits.argmax(-1)
            out.append(tok[:3].tolist())
            lgs.append(logits[:3])
            pos = torch.where(pos < 128, pos + 1, pos)
        streams[fused], logits_of[fused] = out, torch.stack(lgs)
    assert streams[True] == streams[False]
    np.testing.assert_allclose(logits_of[True].numpy(), logits_of[False].numpy(),
                               atol=1e-4, rtol=1e-4)
