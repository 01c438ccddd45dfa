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
  descriptors; its shared memory fits at every head dim.
"""

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da
from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
from p2p_llm_tunnel_tpu_torch.ops import prefill_attention as pa
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
