"""The launch geometry of the port's prefill flash kernel (kernel 1) and of
the split-KV decode body that the fused decode layer (kernel 4, one new
row per slot) and the fused verify layer (kernel 5) share, on the CPU:

- kernel 1's shared memory per block, as ``csrc/flash_causal_attention.cu``
  lays it out, within the card's 227 KB at every head dim it is built for,
  and two blocks per SM at D <= 128;
- kernel 4's instances: ``fits`` admits every head dim at one row per
  slot up to 72 query heads per KV head (the body's row limit) and within
  the card's shared memory, and refuses past it;
- kernel 4's split choice and workspace at the serving shape (B 17, 8 KV
  heads, view 512): four 128-key splits, 544 blocks; one arrival counter
  per (slot, head), zero, shared with kernel 5;
- the engine's fence verdicts (``fence_reason``) for the served presets
  and for geometries with no instance;
- kernel 2's launch plan (the split-KV body at one row per slot) at every
  head dim and every preset's grouping: its splits cover the view in whole
  64-key tiles, its shared memory fits, its workspace holds one partial
  per (slot, head, split, key slice, query row);
- kernel 6's launch plan: its query tiles cover every real and pad q-block
  of a group exactly once, for the chip smoke test's serving group and for
  groups planned at the engine's buckets, from a grid computed without the
  descriptors; its shared memory fits at every head dim;
- under ``--dp-dcn 2`` each rank launches kernels 2, 4 and 6 at its own
  slot count (8 of the 16 cache rows of 15 slots + the scratch row):
  kernel 2's and kernel 4's splits, workspaces and arrival counters at
  that count (counters of their own, zeroed), and kernel 6 over the group
  a rank re-plans from its rows of a wave (no pad block, each row's tokens
  and history start unchanged, slots in its cache block);
- kernel 7's launch plan: the decode plan's 32 x 128 tile for a decode
  step (17 rows, one tile) and every verify burst, the prefill plan's
  128 x 256 tile above 160 rows; at every llama3-8b projection and the
  head and at 1-1024 rows, grids and splits that cover M, N and K exactly,
  splits of whole slabs and whole int4 groups that fill one wave (two
  blocks an SM at decode), the workspace and counters the plan states, and
  stages whose weight share is the source note's; shared memory that fits
  two decode blocks an SM, or one prefill block, in every form, layout and
  group size; and the shapes the reference serves beyond llama3-8b's:
  tiny-qwen's head (N 259: column tiles past N, workspace rows of 260),
  int4 groups of 2, 8 and 24 (scale rows covering every byte row's group,
  splits of whole groups, two decode blocks an SM down to group 8) and a
  contracted length no multiple of 16.
"""

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa
from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import _SUPPORTED_D

#: Shared memory of one H100 SM, less the 1 KB the card reserves per block.
SM_BYTES = 233472
BLOCK_RESERVED = 1024

PRESETS = ["llama3-8b", "gemma2-2b", "llama3.2-1b", "llama3-70b", "qwen2-7b",
           "tiny-gemma"]


@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_prefill_kernel_shared_memory_fits_every_head_dim(d):
    smem = fa.smem_bytes(d)
    assert smem <= kernel_build.MAX_SMEM_BYTES
    if d <= 128:  # two blocks per SM at the served head dims up to 128
        assert 2 * (smem + BLOCK_RESERVED) <= SM_BYTES
    if d == 128:
        # q [64, 136] + two stages of K and V [64, 136] in bf16, 128 valid bytes.
        assert smem == 87168


@pytest.mark.parametrize("d", _SUPPORTED_D)
def test_kernel4_fits_every_head_dim_up_to_the_row_limit(d):
    for g in (1, 4, 7, 8, 16, fd.MAX_ROWS):
        assert fd.fits(d, 1, g) is None, (d, g)
        assert fd.smem_bytes(d, 1, g) <= fd.MAX_SMEM_BYTES
    assert str(fd.MAX_ROWS) in fd.fits(d, 1, fd.MAX_ROWS + 1)
    if d == 128:
        # G 4 pads to one 16-row tile: q [16, 136] and two stages of K and V
        # [64, 136] in bf16; the merge phase's five [1, 128] f32 planes are
        # less.
        assert fd.smem_bytes(128, 1, 4) == 2 * 16 * 136 + 8 * 64 * 136


@pytest.mark.parametrize("d", [0, 48, 96, 512])
def test_kernel4_refuses_head_dims_it_has_no_instance_for(d):
    assert "head_dim" in fd.fits(d, 1, 4)


def test_kernel4_splits_fill_the_card_at_the_serving_shape():
    nsplit, keys = fd.kv_splits(512, 17, 8)
    assert (nsplit, keys) == (4, 128)
    assert 17 * 8 * nsplit == 544


@pytest.mark.parametrize("view", [1, 63, 64, 65, 300, 512, 1024])
def test_kernel4_workspace_holds_one_partial_per_warp_slice(view):
    b, kh, g, d = 3, 2, 4, 32
    nsplit, keys, part_acc, part_ml, arrivals = fd.split_kv_workspace(
        torch.device("cpu"), b, kh, 1, g, d, view)
    assert (nsplit, keys) == fd.kv_splits(view, b, kh)
    # One 16-row tile at T 1, G 4: four warps, one 16-key slice each.
    parts = b * kh * nsplit * 4 * g
    assert part_acc.numel() == parts * d and part_ml.numel() == parts * 2
    assert part_acc.dtype == part_ml.dtype == torch.float32
    assert arrivals.dtype == torch.int32 and tuple(arrivals.shape) == (b * kh,)


def test_kernel4_and_kernel5_share_zeroed_arrival_counters():
    dev = torch.device("cpu")
    *_, a4 = fd.split_kv_workspace(dev, 5, 3, 1, 4, 32, 512)
    *_, a5 = fd.split_kv_workspace(dev, 5, 3, 5, 4, 32, 512)
    assert a4 is a5 and not a4.any()


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("burst", [0, 2, 5, 9])  # off, --spec-k 1 and 4, --spec-k-max 8
def test_engine_keeps_the_fused_layer_for_every_served_preset(preset, burst):
    cfg = get_config(preset)
    assert fd.fence_reason(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, burst) is None


@pytest.mark.parametrize("d,g,burst,kernel", [
    (48, 4, 0, "decode"),    # no head-dim instance
    (128, 73, 0, "decode"),  # past the body's 72 rows at one row per slot
    (128, 16, 0, None),      # G 16: kernel 4 has an instance now
    (128, 16, 5, "verify"),  # 80 rows in a verify burst of 5
    (128, 8, 10, "verify"),  # --spec-k-max 9 at G 8: 80 rows
    (256, 8, 9, None),
])
def test_engine_fence_verdicts(d, g, burst, kernel):
    why = fd.fence_reason(d, g, burst)
    if kernel is None:
        assert why is None
    else:
        assert why is not None and f"fused {kernel} kernel" in why


# -- kernel 2: the split-KV body at one row per slot ------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("d", _SUPPORTED_D)
def test_kernel2_plan_at_every_head_dim_and_preset_grouping(d, preset):
    cfg = get_config(preset)
    kh = cfg.n_kv_heads
    g = cfg.n_heads // kh
    b = 17  # 16 slots + the scratch row
    for s in (2, 64, 128, 256, 512, 1024):
        nsplit, keys, part_acc, part_ml, arrivals = fd.split_kv_workspace(
            torch.device("cpu"), b, kh, 1, g, d, s)
        assert (nsplit, keys) == fd.kv_splits(s, b, kh)
        assert keys % 64 == 0 and nsplit * keys >= s > (nsplit - 1) * keys
        assert nsplit <= fd.MAX_SPLITS
        # G rows padded to 16-row tiles; warps share a tile by key slices.
        parts = b * kh * nsplit * fd._key_slices(-(-g // 16)) * g
        assert part_acc.numel() == parts * d and part_ml.numel() == parts * 2
        assert tuple(arrivals.shape) == (b * kh,) and not arrivals.any()
    assert fd.fits(d, 1, g) is None
    assert fd.smem_bytes(d, 1, g) <= kernel_build.MAX_SMEM_BYTES


def test_kernel2_group_limits():
    # Kernel 2 holds the split-KV body's rows at one row per slot (G <= 72);
    # kernel 3, the plane kernel, keeps its 8.
    assert da._MAX_GROUP == fd.MAX_ROWS
    assert da._PLANE_MAX_GROUP == 8
    q = torch.zeros((1, 1, 9, 16))
    kc = torch.zeros((1, 128, 1, 16))
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="H/K <= 8"):
        da._check(q, kc, kc, None, None, pos, None, max_group=da._PLANE_MAX_GROUP)


# -- kernels 2, 4 and 6 at a dp rank's slot count ----------------------------

#: A dp 2 rank's cache rows: 15 slots + the scratch row over two ranks.
DP_ROWS = 8


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("t", [1, 5])  # kernel 2/4 (one row a slot), kernel 5
def test_split_kv_plans_at_a_dp_ranks_slot_count(preset, t):
    cfg = get_config(preset)
    kh, d = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kh
    dev = torch.device("cpu")
    for view in (64, 128, 512, 1024):
        nsplit, keys, part_acc, part_ml, arrivals = fd.split_kv_workspace(
            dev, DP_ROWS, kh, t, g, d, view)
        assert (nsplit, keys) == fd.kv_splits(view, DP_ROWS, kh)
        assert keys % 64 == 0 and nsplit * keys >= view > (nsplit - 1) * keys
        assert nsplit <= fd.MAX_SPLITS
        rows = t * g
        parts = DP_ROWS * kh * nsplit * fd._key_slices(-(-rows // 16)) * rows
        assert part_acc.numel() == parts * d and part_ml.numel() == parts * 2
        assert tuple(arrivals.shape) == (DP_ROWS * kh,) and not arrivals.any()
    # The dp rank's counters are its own, not those of a 17-row launch.
    *_, whole = fd.split_kv_workspace(dev, 17, kh, t, g, d, 512)
    assert whole is not arrivals and tuple(whole.shape) == (17 * kh,)


def test_kernel4_splits_at_a_dp_ranks_slot_count():
    """Half the slots, the same card: the split count doubles (eight
    64-key splits at view 512, 512 blocks against 17 rows' 544), so a dp
    rank's launch still fills the card."""
    assert fd.kv_splits(512, DP_ROWS, 8) == (8, 64)
    assert fd.kv_splits(512, 17, 8) == (4, 128)


@pytest.mark.parametrize("d", _SUPPORTED_D)
@pytest.mark.parametrize("dp_rank", [0, 1])
def test_kernel6_tiles_cover_a_dp_ranks_replanned_group(d, dp_rank):
    import types

    import numpy as np

    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine
    from p2p_llm_tunnel_tpu_torch.parallel.data_parallel import SlotShard
    from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh

    # The serving group's rows on slots 3, 9, 0, 14, 5, 11, 8, 2 of 15.
    slots = [3, 9, 0, 14, 5, 11, 8, 2]
    entries = [(s, st, ln) for s, (st, ln) in zip(slots, RAGGED_ROWS)]
    full = pa.plan_ragged_group(entries, 16, 1024, scratch_slot=15)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 500, 1024).astype(np.int32)
    sample_idx = np.array([off + ln - 1 for off, (_s, _st, ln)
                           in zip(full[5], entries)])
    samp_pos = np.array([st + ln for _s, st, ln in entries], np.int32)
    shard = SlotShard(Mesh(dp=2, rank=dp_rank), 16, scratch=15)
    eng = types.SimpleNamespace(_ragged_bq=16, _dp=shard, _ragged_row_blocks=8)
    rows = shard.route(slots)
    flat, descs, s_idx, s_pos = InferenceEngine._replan_ragged(
        eng, tokens, [full[0], full[1], full[2], full[4]], sample_idx, samp_pos,
        rows)
    slot_of, start_of, qoff_of, base_of = descs
    assert not (slot_of == 15 - shard.lo).any()  # no pad block
    assert len(flat) == sum(-(-entries[i][2] // 16) * 16 for i in rows)
    for j, i in enumerate(rows):
        s, st, ln = entries[i]
        first = int(s_idx[j]) - ln + 1
        assert (flat[first:first + ln] == tokens[full[5][i]:full[5][i] + ln]).all()
        assert slot_of[first // 16] == s - shard.lo
        assert start_of[first // 16] == st and s_pos[j] == st + ln
    plan = (slot_of, start_of, qoff_of, None, base_of, None)
    _covered(plan, d, 4, 8, 16)


# -- kernel 6: query tiles over the 16-token q-blocks ------------------------

#: chip_smoke.py's serving group: (history, tail) per row, TOT 1024.
RAGGED_ROWS = [(0, 100), (16, 37), (128, 128), (368, 77), (512, 5), (0, 120),
               (128, 63), (368, 99)]


def _covered(plan, d, g, kh, bq):
    """Map the launch's blocks to q-blocks by the kernel's rule; every
    q-block must belong to exactly one tile, of one row, in one block."""
    slot_of, start_of, qoff_of, _qlen, base_of, _offs = plan
    nqb = len(base_of)
    qpt = pa.q_blocks_per_tile(d, g, bq)
    grid = pa.launch_grid(nqb, g * kh, kh, d, bq)
    assert grid[:2] == (nqb, kh)
    # The row chunks of a full tile hold its rows; no chunk is all padding.
    rows = qpt * bq * g
    assert grid[2] * pa.block_rows(d) >= rows > (grid[2] - 1) * pa.block_rows(d)
    seen = [0] * nqb
    for first, n in pa.query_tiles(qoff_of, base_of, bq, qpt):
        assert 1 <= n <= qpt
        for j in range(first, first + n):
            seen[j] += 1
            assert base_of[j] == base_of[first] and slot_of[j] == slot_of[first]
            assert start_of[j] == start_of[first]
            assert qoff_of[j] == qoff_of[first] + (j - first) * bq
    assert seen == [1] * nqb
    return qpt


@pytest.mark.parametrize("d", _SUPPORTED_D)
def test_kernel6_tiles_cover_the_serving_group_once(d):
    entries = [(i, st, ln) for i, (st, ln) in enumerate(RAGGED_ROWS)]
    plan = pa.plan_ragged_group(entries, 16, 1024, scratch_slot=16)
    qpt = _covered(plan, d, 4, 8, 16)
    assert qpt == (2 if d <= 128 else 1)
    if d == 128:
        # 43 real q-blocks in 24 tiles, 21 pad q-blocks in 21: a row of
        # n q-blocks reads its history ceil(n / 2) times per KV head.
        tiles = pa.query_tiles(plan[2], plan[4], 16, qpt)
        real = [t for t in tiles if plan[0][t[0]] != 16]
        assert (len(real), len(tiles) - len(real)) == (24, 21)


@pytest.mark.parametrize("preset", PRESETS)
def test_kernel6_tiles_cover_engine_buckets_once(preset):
    import numpy as np

    cfg = get_config(preset)
    kh = cfg.n_kv_heads
    g = cfg.n_heads // kh
    rng = np.random.default_rng(len(preset))
    for rows_, per_row in ((8, 128), (8, 16), (4, 64), (1, 256)):
        tot = rows_ * per_row
        for _ in range(20):
            n = int(rng.integers(1, rows_ + 1))
            entries = []
            for slot in range(n):
                tail = int(rng.integers(1, per_row + 1))
                entries.append((slot, 16 * int(rng.integers(0, 40)), tail))
            plan = pa.plan_ragged_group(entries, 16, tot, scratch_slot=rows_,
                                        max_row_blocks=per_row // 16)
            _covered(plan, cfg.head_dim, g, kh, 16)


@pytest.mark.parametrize("form", [None, "int8", "int4"])
@pytest.mark.parametrize("d", _SUPPORTED_D)
def test_kernel6_shared_memory_fits_every_head_dim(d, form):
    smem = pa.smem_bytes(d, form)
    assert smem <= kernel_build.MAX_SMEM_BYTES
    if d == 128:
        # q [128, 136] + two stages of K and V [64, 136] in bf16, two stages
        # of 64 key and value scales; a quantized cache adds one byte stage
        # (int4: 32 byte rows a plane), so raw and int4 fit two blocks an SM.
        stage = {None: 0, "int8": 2 * 64 * 128, "int4": 2 * 32 * 128}[form]
        assert smem == 2 * 128 * 136 + 8 * 64 * 136 + 1024 + stage
        assert (2 * (smem + BLOCK_RESERVED) <= SM_BYTES) == (form != "int8")


#: llama3-8b's projections and head as kernel 7 sees them: N x K.
KERNEL7_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (1024, 4096),
                  "w_gate/w_up": (14336, 4096), "w_down": (4096, 14336),
                  "lm_head": (128256, 4096)}


@pytest.mark.parametrize("m,plan", [(1, "decode"), (17, "decode"), (85, "decode"),
                                    (153, "decode"), (160, "decode"),
                                    (161, "prefill"), (1024, "prefill"),
                                    (2048, "prefill")])
def test_kernel7_plan_picks_the_tile_by_rows(m, plan):
    """Decode steps (16 slots + the parked row) take the 24-row tile (one
    wgmma N), verify bursts (17 x T, T <= 9) 32-row tiles, prefill the
    128 x 256 one."""
    p = qm.launch_plan(m, 4096, 4096)
    assert p["plan"] == plan and p["bn"] == qm.PLANS[plan][1]
    assert p["bm"] == (24 if m <= 24 else qm.PLANS[plan][0])
    assert p["grid"][0] * p["bm"] >= m > (p["grid"][0] - 1) * p["bm"]
    if m == 17:
        # One M tile (each weight byte read once), 32 column tiles, and 8
        # splits of 2 slabs: 256 blocks, one wave of two blocks an SM.
        assert p["grid"] == (1, 32, 8)


KERNEL7_ROWS = [1, 17, 85, 153, 160, 161, 1024]
#: The decode step's grids (M tiles, column tiles, splits): one wave of
#: 264 blocks where the column tiles leave room, whole slabs a split.
M17_GRIDS = {"wq/wo": (1, 32, 8), "wk/wv": (1, 8, 16), "w_gate/w_up": (1, 112, 2),
             "w_down": (1, 32, 8), "lm_head": (1, 1002, 1)}


def _split_slabs(p, k):
    """Each split's [first, last) slab, as the kernel's split_range."""
    return [(k0 // p["bk"], -(-k1 // p["bk"])) for k0, k1 in qm.split_ranges(p, k)]


@pytest.mark.parametrize("form", qm.FORMS)
@pytest.mark.parametrize("m", KERNEL7_ROWS)
@pytest.mark.parametrize("shape", sorted(KERNEL7_SHAPES))
def test_kernel7_grid_covers_the_main_path_shapes(shape, m, form):
    n, k = KERNEL7_SHAPES[shape]
    for layout in ("kn", "nk"):
        for gs in ((16, 64, 128) if form == "int4" else (128,)):
            p = qm.launch_plan(m, n, k, form, layout, gs)
            gm, gn, splits = p["grid"]
            assert splits == p["splits"] and 1 <= splits <= qm.SPLIT_CAP
            # Tiles cover M and N exactly once.
            assert (gm - 1) * p["bm"] < m <= gm * p["bm"]
            assert (gn - 1) * p["bn"] < n <= gn * p["bn"] and gn <= 65535
            # Splits tile K in order, without gap or overlap, none empty,
            # each whole slabs and (int4) whole groups.
            ranges = qm.split_ranges(p, k)
            assert ranges[0][0] == 0 and ranges[-1][1] == k
            assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
            assert all(k1 > k0 for k0, k1 in ranges)
            for k0, _ in ranges:
                assert k0 % p["bk"] == 0
                if form == "int4":
                    assert k0 % gs == 0
            assert sum(s1 - s0 for s0, s1 in _split_slabs(p, k)) == p["nslabs"]
            # Splits fill one wave (two blocks an SM at decode, one at
            # prefill) and share the units evenly where a divisor allows.
            units = -(-p["nslabs"] // p["unit_slabs"])
            wave = qm.SPLIT_TARGET[p["plan"]]
            if splits > 1:
                assert gm * gn * splits <= wave and units % splits == 0
            if gm * gn * splits <= wave // 2 and splits < min(units, qm.SPLIT_CAP):
                assert units % (2 * splits) or gm * gn * 2 * splits > wave
            if m == 17 and layout == "kn" and gs == 128:
                assert (gm, gn, splits) == M17_GRIDS[shape]
            # The merge's workspace (f32 / int32 partials of the real rows)
            # and one counter per output tile, only when K is split.
            assert p["workspace_bytes"] == (splits * m * n * 4 if splits > 1 else 0)
            assert p["counters"] == (gm * gn if splits > 1 else 0)
            # Stages: weights, scales and (prefill) the x tile fit the
            # block budget; decode stages are weight bytes and scale rows
            # only, 8 KB of weights a slab.
            st = p["stage"]
            assert p["smem"] <= kernel_build.MAX_SMEM_BYTES
            wk = p["bk"] // 2 if form == "int4" else p["bk"]
            assert st["w_copied"] == wk * p["bn"]
            if p["plan"] == "prefill":
                # One 128-byte row of x a slab: wgmma's swizzle span.
                assert p["bk"] * (1 if form == "w8a8" else 2) == 128
                assert st["x_bytes"] == p["bm"] * 128 and st["stage_bytes"] % 1024 == 0
            if p["plan"] == "decode":
                assert st["w_copied"] == 16384
                assert st["x_bytes"] == 0 and p["xpiece"] % p["bk"] == 0
                assert 2 * (p["smem"] + BLOCK_RESERVED) <= SM_BYTES
                if form == "int4" and gs == 128 and layout == "kn":
                    # The source note: 94% of a stage's copied bytes are
                    # weights at group 128 (16384 of 17408).
                    share = st["w_copied"] / (st["w_copied"] + st["s_copied"])
                    assert st["s_copied"] == 1024 and round(share, 2) == 0.94


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("form", qm.FORMS)
@pytest.mark.parametrize("plan", sorted(qm.PLANS))
def test_kernel7_shared_memory_fits_two_blocks(plan, form, layout):
    """Two decode blocks an SM at every row count up to 160; one prefill
    block; the second warpgroup's sums (4 warps x 2 m-tiles x 16 values x
    32 lanes) fit the decode ring they are handed through."""
    for gs in ((16, 48, 64, 128, 256) if form == "int4" else (128,)):
        for m in ((1, 17, 32, 85, 160) if plan == "decode" else (161, 1024)):
            p = qm.launch_plan(m, 4096, 4096, form, layout, gs)
            smem = qm.smem_bytes(p)
            assert smem == p["smem"]
            blocks = 2 if plan == "decode" else 1
            assert blocks * (smem + BLOCK_RESERVED) <= SM_BYTES
            assert 1 <= p["srows"] <= 16 and 2 <= p["stages"] <= qm.PLANS[plan][2]
            st = p["stage"]
            assert st["stage_bytes"] % 1024 == 0 and st["w_row"] % 16 == 0
            if plan == "decode":
                ring = p["stages"] * st["stage_bytes"]
                assert 4 * 2 * 16 * 32 * 4 <= ring
    if (plan, form, layout) == ("decode", "int4", "kn"):
        # 128 byte rows of 128 columns as TMA writes them, and two scale
        # rows of 128 f32 at group 128.
        st = qm.stage_layout("decode", "int4", "kn", 128)
        assert (st["w_bytes"], st["s_bytes"], st["stage_bytes"]) == (16384, 1024, 17408)


@pytest.mark.parametrize("m", KERNEL7_ROWS)
@pytest.mark.parametrize("form", qm.FORMS)
def test_kernel7_plan_at_tiny_qwens_head(form, m):
    """tiny-qwen's untied head, N 259 x K 64: the column tiles cover N (the
    last one mostly past it, where TMA zero-fills and no store lands), the
    merge workspace has rows of 260 (whole 16-byte pieces of partials)."""
    p = qm.launch_plan(m, 259, 64, form, "kn", 32)
    gm, gn, splits = p["grid"]
    assert (gn - 1) * p["bn"] < 259 <= gn * p["bn"]
    assert (gm - 1) * p["bm"] < m <= gm * p["bm"]
    assert p["ldp"] == 260
    assert p["workspace_bytes"] == (splits * m * 260 * 4 if splits > 1 else 0)
    assert p["smem"] <= kernel_build.MAX_SMEM_BYTES
    if p["plan"] == "decode":
        assert 2 * (p["smem"] + BLOCK_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("m", [1, 17, 153, 1024])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("gs", [2, 8, 24])
def test_kernel7_plan_at_narrow_int4_groups(gs, layout, m):
    """int4 groups narrower than a 16-deep k-step (llama3-8b's wk shape):
    a stage's scale rows hold every group its slab's byte rows touch (a
    byte's two k share a group), splits start on group boundaries, and the
    ring fits two decode blocks an SM down to group 8 (group 2's 128 scale
    rows a stage take one block's shared memory)."""
    n, k = 1024, 4096
    p = qm.launch_plan(m, n, k, "int4", layout, gs)
    bk = p["bk"]
    for s in range(p["nslabs"]):
        first, last = s * bk // gs, (s * bk + bk - 2) // gs
        assert last - first + 1 <= p["srows"] <= 256
    for k0, _ in qm.split_ranges(p, k):
        assert k0 % gs == 0 and k0 % bk == 0
    assert p["smem"] <= kernel_build.MAX_SMEM_BYTES and p["stages"] >= 2
    if p["plan"] == "decode":
        assert p["xpiece"] >= bk
        assert (2 * (p["smem"] + BLOCK_RESERVED) <= SM_BYTES) == (gs >= 8)
    if (gs, p["plan"]) == (8, "decode"):
        assert p["srows"] == 32
    if (gs, p["plan"]) == (24, "decode"):
        assert p["srows"] == 12


@pytest.mark.parametrize("form", qm.FORMS)
def test_kernel7_plan_at_a_k_tail(form):
    """K 4100: the splits cover it to its last position in whole slabs (the
    last partial; x is zero-padded to 4112 by the wrapper)."""
    p = qm.launch_plan(17, 1024, 4100, form, "kn", 128)
    ranges = qm.split_ranges(p, 4100)
    assert ranges[0][0] == 0 and ranges[-1][1] == 4100
    assert p["nslabs"] == -(-4100 // p["bk"])


# ---------------------------------------------------------------------------
# kernel 3: the plane kernel's cluster plan
# ---------------------------------------------------------------------------

#: H100 SMs; the main path's kernel-3 shape (B 17 rows, 8 KV heads, S 512).
SMS = 132


@pytest.mark.parametrize("d", _SUPPORTED_D)
@pytest.mark.parametrize("s", [128, 256, 384, 512, 1024, 4096])
def test_kernel3_plan_geometry(s, d):
    """Over slots, KV heads and groupings: the cluster is 1, 2, 4 or 8 and
    spans the grid's rank axis; every 64-key tile of [0, S) belongs to
    exactly one CTA of a cluster and no rank starts past S; the ring fits and its shared memory is the
    source's (2 KB + stages x 2 x 64 x D bf16), within the card's 227 KB."""
    tiles = s // da.PLANE_TILE
    for b in (1, 5, 17, 64):
        for kh in (1, 2, 8):
            for g in (1, 4, 7, 8):
                p = da.plane_plan(b, s, kh, g, d)
                assert p.cluster in da.PLANE_CLUSTERS
                assert p.grid == (p.cluster, kh, b) and p.grid[0] % p.cluster == 0
                owner = [r for r in range(p.cluster)
                         for t in range(r * p.tiles_per_cta, (r + 1) * p.tiles_per_cta)
                         if t < tiles]
                assert len(owner) == tiles  # each tile once, in rank order
                assert owner == sorted(owner) and owner[0] == 0
                assert p.cluster <= tiles
                assert (p.cluster - 1) * p.tiles_per_cta < tiles
                assert 1 <= p.stages <= min(2, p.tiles_per_cta)
                assert p.smem_bytes == 2048 + p.stages * 2 * 64 * d * 2
                assert p.smem_bytes <= kernel_build.MAX_SMEM_BYTES
                if b * kh * p.cluster < 2 * SMS:
                    # the cluster grew as far as the plane or the ABI allow
                    c2 = 2 * p.cluster
                    assert p.cluster == 8 or (c2 - 1) * -(-tiles // c2) >= tiles


@pytest.mark.parametrize("s", [512, 1024, 4096])
def test_kernel3_plan_at_the_main_path_shape(s):
    """B 17, 8 KV heads (llama3-8b's heads) at views 512 (the main path's
    bucket), 1024 and 4096: clusters of 2, 272 CTAs (at least two an SM on
    132 SMs), each walking half the plane through a 2-stage ring, and three
    CTAs' shared memory fit an SM, so the grid is one wave."""
    p = da.plane_plan(17, s, 8, 4, 128)
    assert (p.cluster, p.tiles_per_cta, p.stages) == (2, s // 128, 2)
    ctas = p.grid[0] * p.grid[1] * p.grid[2]
    assert ctas == 272 and ctas >= 2 * SMS
    assert 3 * (p.smem_bytes + BLOCK_RESERVED) <= SM_BYTES
    assert ctas <= 3 * SMS


@pytest.mark.parametrize("b,kh,cluster", [(1, 8, 8), (4, 8, 8), (9, 8, 4), (17, 4, 4),
                                            (1, 1, 8)])
def test_kernel3_plan_grows_the_cluster_for_few_slots(b, kh, cluster):
    """Few (slot, KV head) pairs: the cluster grows up to 8 ranks along S
    to reach two CTAs an SM."""
    p = da.plane_plan(b, 4096, kh, 4, 128)
    assert p.cluster == cluster and p.cluster * p.tiles_per_cta == 64


@pytest.mark.parametrize("s,g", [(100, 4), (512, 9), (512, 0)])
def test_kernel3_plan_refuses_what_the_kernel_does_not_take(s, g):
    with pytest.raises(ValueError):
        da.plane_plan(17, s, 8, g, 128)


@pytest.mark.cuda
def test_kernel3_matches_its_plain_version_on_the_card():
    """On the card (chip_smoke.py phase 2 holds views 512, 1024 and 4096
    and five preset geometries): kernel 3 within chip_smoke's tolerance of
    its plain version on a strided [:, :S] cache view, with a parked row,
    and two launches on equal inputs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 3 is CUDA C++ and has no "
                    "interpret mode (chip_smoke.py runs it on the card)")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, kh, d = 17, 512, 32, 8, 128
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    kc = torch.randn((b, 1024, kh, d), generator=g, device="cuda").bfloat16()[:, :s]
    vc = torch.randn((b, 1024, kh, d), generator=g, device="cuda").bfloat16()[:, :s]
    pos = torch.tensor([0, 1, 63, 64, 65, 127, 128, 255, 256, 257, 300, 383, 400,
                        500, 510, 511, 1024], dtype=torch.int32, device="cuda")
    got = da.flash_decode_attention_plane(q, kc, vc, pos)
    again = da.flash_decode_attention_plane(q, kc, vc, pos)
    want = da.plain(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=2e-2)
