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
  and for geometries with no instance.
"""

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
from p2p_llm_tunnel_tpu_torch.ops import fused_decode as fd
from p2p_llm_tunnel_tpu_torch.ops import kernel_build
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


def test_prefill_kernel_shared_memory_at_llama3_8b():
    # q [64, 136] + two stages of K and V [64, 136] in bf16, 128 valid bytes.
    assert fa.smem_bytes(128) == 87168


@pytest.mark.parametrize("d", _SUPPORTED_D)
def test_kernel4_fits_every_head_dim_up_to_the_row_limit(d):
    for g in (1, 4, 7, 8, 16, fd.MAX_ROWS):
        assert fd.fits(d, 1, g) is None, (d, g)
        assert fd.smem_bytes(d, 1, g) <= fd.MAX_SMEM_BYTES
    assert str(fd.MAX_ROWS) in fd.fits(d, 1, fd.MAX_ROWS + 1)


@pytest.mark.parametrize("d", [0, 48, 96, 512])
def test_kernel4_refuses_head_dims_it_has_no_instance_for(d):
    assert "head_dim" in fd.fits(d, 1, 4)


def test_kernel4_smem_at_one_row_is_the_attention_phase():
    # G 4 pads to one 16-row tile: q [16, 136] and two stages of K and V
    # [64, 136] in bf16; the merge phase's five [1, 128] f32 planes are less.
    assert fd.smem_bytes(128, 1, 4) == 2 * 16 * 136 + 8 * 64 * 136


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
