"""Kernel 3 (the legacy whole-plane decode kernel) of the port, on the CPU:
``ops/decode_attention.flash_decode_attention_plane`` runs its plain version
(``cached_attention``) for CPU tensors; it is held against the JAX
package's ``flash_decode_attention_plane`` in interpret mode at small
shapes (head dims 16-128, 1-8 query rows per KV head, S <= 256), with and
without window and softcap (fp32, within 1e-5: the same softmax in another
summation order) on the live rows.  A parked row (pos >= S) is compared
nowhere against JAX: the reference encodes "no window" as S + 1, so its
parked rows skip the plane's first keys, where the port's INT32_MAX
(ROADMAP Queue 3) attends the whole plane, as kernel 2 does.

The kernel's split and merge are emulated here in fp32, as
``csrc/flash_decode_attention_plane.cu`` does them on :func:`plane_plan`'s
layout: each rank of a cluster walks its own 64-key tiles from key 0,
never a tile past the frontier; four warps a CTA take 16 keys of each tile
with their own online softmax, the CTA merges its warps in order and rank
0 merges the ranks in order.  The emulation is held against
``cached_attention`` within 1e-5 at tile-edge positions, parked rows,
window + softcap and clusters whose last ranks lie past the frontier.
The wrapper's input rules (raw cache, G <= 8, cuda or cpu) hold on the
CPU too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    flash_decode_attention_plane as j_plane,
)
from p2p_llm_tunnel_tpu_torch.models import transformer  # noqa: F401  (import order)
from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
from p2p_llm_tunnel_tpu_torch.ops.attention import _NEG_INF, cached_attention

SHAPES = [(3, 128, 4, 2, 32), (4, 256, 8, 2, 16),  # (B, S, H, K, D)
          (3, 256, 8, 8, 64), (3, 128, 8, 1, 128)]  # G 1 at D 64, G 8 at D 128


@pytest.mark.parametrize("kw", [{}, dict(window=40, softcap=5.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plane_plain_matches_jax_interpret(shape, kw):
    b, s, h, kh, d = shape
    rng = np.random.default_rng(s + len(kw))
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    pos = np.array([0, 77, s - 1, s + 5][:b], np.int32)
    want = j_plane(*[jnp.asarray(x) for x in (q, k, v, pos)], interpret=True, **kw)
    got = da.flash_decode_attention_plane(*[torch.from_numpy(x) for x in (q, k, v, pos)],
                                          **kw)
    live = pos < s  # parked rows: JAX's "no window" is S + 1, the port's INT32_MAX
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-5, rtol=1e-5)


def test_plane_wrapper_needs_whole_128_key_blocks():
    q = torch.zeros((1, 1, 2, 16))
    kv = torch.zeros((1, 100, 1, 16))
    with pytest.raises(ValueError, match="128"):
        da.flash_decode_attention_plane(q, kv, kv, torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the wrapper's input rules, on either device
# ---------------------------------------------------------------------------

def test_plane_wrapper_refuses_a_quantized_cache():
    q = torch.zeros((1, 1, 2, 16))
    kv = torch.zeros((1, 128, 1, 16), dtype=torch.int8)
    with pytest.raises(TypeError, match="raw cache"):
        da.flash_decode_attention_plane(q, kv, kv, torch.zeros(1, dtype=torch.int32))


def test_plane_wrapper_refuses_more_than_eight_rows_per_kv_head():
    q = torch.zeros((1, 1, 9, 16))
    kv = torch.zeros((1, 128, 1, 16))
    with pytest.raises(ValueError, match="H/K <= 8"):
        da.flash_decode_attention_plane(q, kv, kv, torch.zeros(1, dtype=torch.int32))


def test_plane_wrapper_runs_on_cuda_or_cpu_only():
    q = torch.zeros((1, 1, 2, 16), device="meta")
    kv = torch.zeros((1, 128, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.flash_decode_attention_plane(q, kv, kv,
                                        torch.zeros(1, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# the split and merge of the kernel, emulated in fp32
# ---------------------------------------------------------------------------

WARPS, WARP_KEYS = 4, 16  # consumer warps a CTA, keys of a tile each


def _merge(parts):
    """Partials (m [G], l [G], acc [G, D]) merged in order, as the kernel's
    ``merge``: the max of the maxima, each partial rescaled to it, a
    partial that saw no key adding nothing."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        f = torch.where(pm == _NEG_INF, torch.zeros_like(pm), torch.exp(pm - m))
        l = l + pl * f
        acc = acc + pa * f[:, None]
    return m, l, acc


def emulate(q, k, v, pos, plan, scale=None, softcap=None, window=None):
    """Kernel 3's function the way it splits and merges on ``plan``, in
    fp32: -> (out [B, 1, H, D], tiles each slot's cluster loaded)."""
    b, _, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5 if scale is None else scale
    win = 2**31 - 1 if window is None else window
    qf = q.float().reshape(b, kh, g, d)
    out = torch.zeros(b, kh, g, d)
    loaded = []
    for bi in range(b):
        p = int(pos[bi])
        last = min(p, s - 1)
        slot_tiles = 0
        for hh in range(kh):
            ranks = []
            for r in range(plan.cluster):
                t0 = r * plan.tiles_per_cta
                n = max(min(t0 + plan.tiles_per_cta, last // da.PLANE_TILE + 1) - t0, 0)
                if hh == 0:
                    slot_tiles += n
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), _NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, d)
                    for i in range(n):
                        keys = (t0 + i) * da.PLANE_TILE + w * WARP_KEYS + torch.arange(WARP_KEYS)
                        sc = (k[bi, keys, hh].float() @ qf[bi, hh].T) * scale  # [16, G]
                        if softcap is not None:
                            sc = softcap * torch.tanh(sc / softcap)
                        ok = ((keys <= last) & (p - keys < win))[:, None]
                        sc = torch.where(ok, sc, torch.full_like(sc, _NEG_INF))
                        m_new = torch.maximum(m, sc.amax(0))
                        corr = torch.where(m == _NEG_INF, torch.zeros_like(m),
                                           torch.exp(m - m_new))
                        pr = torch.where(sc == _NEG_INF, torch.zeros_like(sc),
                                         torch.exp(sc - m_new))
                        vt = torch.where((keys <= last)[:, None], v[bi, keys, hh].float(),
                                         torch.zeros(WARP_KEYS, d))
                        l = l * corr + pr.sum(0)
                        acc = acc * corr[:, None] + pr.T @ vt
                        m = m_new
                    warps.append((m, l, acc))
                ranks.append(_merge(warps))
            _, l, acc = _merge(ranks)
            out[bi, hh] = acc / l.clamp(min=1e-30)[:, None]
        loaded.append(slot_tiles)
    return out.reshape(b, 1, h, d), loaded


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, 1, h, d), (b, s, kh, d), (b, s, kh, d))]


def _plans(b, s, kh, g, d):
    """plane_plan's own layout, and every other cluster size the kernel
    launches with, with the fewest tiles a rank that cover the plane."""
    tiles = s // da.PLANE_TILE
    own = da.plane_plan(b, s, kh, g, d)
    return [own] + [da.PlanePlan(c, -(-tiles // c), 1, 0, (c, kh, b))
                    for c in da.PLANE_CLUSTERS if c != own.cluster]


def _check(q, k, v, pos, plan, **kw):
    got, loaded = emulate(q, k, v, pos, plan, **kw)
    want = cached_attention(q, k, v, pos, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    s = k.shape[1]
    # The cluster loads exactly the tiles up to the frontier, none past it.
    assert loaded == [min(int(p), s - 1) // da.PLANE_TILE + 1 for p in pos]


@pytest.mark.parametrize("plan_index", range(4))
def test_plane_split_merge_at_tile_edges(plan_index):
    b, s, h, kh, d = 6, 256, 8, 2, 32
    q, k, v = _inputs(b, s, h, kh, d, seed=1)
    pos = torch.tensor([0, 63, 64, 127, 128, s - 1], dtype=torch.int32)
    _check(q, k, v, pos, _plans(b, s, kh, h // kh, d)[plan_index])


@pytest.mark.parametrize("plan_index", range(4))
def test_plane_split_merge_with_a_parked_row(plan_index):
    b, s, h, kh, d = 3, 256, 4, 1, 16
    q, k, v = _inputs(b, s, h, kh, d, seed=2)
    pos = torch.tensor([200, s, 1024], dtype=torch.int32)  # two rows parked
    _check(q, k, v, pos, _plans(b, s, kh, h // kh, d)[plan_index])


@pytest.mark.parametrize("plan_index", range(4))
def test_plane_split_merge_with_window_and_softcap(plan_index):
    b, s, h, kh, d = 5, 256, 8, 2, 16
    q, k, v = _inputs(b, s, h, kh, d, seed=3)
    pos = torch.tensor([0, 63, 130, s - 1, s + 3], dtype=torch.int32)
    _check(q, k, v, pos, _plans(b, s, kh, h // kh, d)[plan_index],
           window=40, softcap=5.0)


@pytest.mark.parametrize("cluster,tiles", [(8, 1), (4, 2)])
def test_plane_split_merge_with_ranks_past_the_frontier(cluster, tiles):
    """At S 512 the frontier of every live row lies in the first ranks'
    tiles: the last ranks load nothing and report an empty partial."""
    b, s, h, kh, d = 4, 512, 4, 1, 16
    q, k, v = _inputs(b, s, h, kh, d, seed=4)
    pos = torch.tensor([0, 10, 64, 100], dtype=torch.int32)
    plan = da.PlanePlan(cluster, tiles, 1, 0, (cluster, kh, b))
    assert all((cluster - 1) * tiles * da.PLANE_TILE > p for p in pos.tolist())
    _check(q, k, v, pos, plan)


def test_plane_split_merge_at_the_main_path_plan():
    """The plan of B 17, 8 KV heads, S 512 (cluster 2, four tiles a rank)
    on narrow heads: decode_positions' block edges and a parked row."""
    s = 512
    plan = da.plane_plan(17, s, 8, 4, 128)
    assert (plan.cluster, plan.tiles_per_cta) == (2, 4)
    b, h, kh, d = 8, 4, 1, 16
    q, k, v = _inputs(b, s, h, kh, d, seed=5)
    pos = torch.tensor([1, 65, 255, 256, 257, 511, 383, 1024], dtype=torch.int32)
    _check(q, k, v, pos, plan)
