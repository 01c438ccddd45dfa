"""Kernel 7 (the dequant-fused weight matmul) takes every product the JAX
package serves quantized, on the CPU:

- ``model_fence`` passes every dense preset under every ``--quant`` and
  int4 at group sizes 8, 24 and 128 (MoE presets are refused earlier, by
  the quantizers, as in the JAX package); ``shape_fence`` refuses only odd
  or empty int4 groups;
- ``models/quant.kernel_layout`` stores tiny-qwen's untied head (259
  columns) and a contracted length that is no multiple of 16 in rows of
  whole 16-byte pieces, zero-padded, as views of the logical shape: the
  values every reader sees are unchanged, the wrapper's stride checks
  accept the padded rows and refuse unpadded ones;
- the plain version behind ``mm`` and ``head_matmul``, on trees carried
  over from JAX by ``params_from_numpy`` (which lays them out), against the JAX functions at N 259, at a K tail and
  at int4 groups 8 and 24; and the kernel's split schedule (each split's
  partial over its K range, merged in split order, per-element group
  scales) against the JAX products at those shapes — bf16 within one bf16
  rounding of the output (rtol 2**-7, atol 2**-7), w8a8 bitwise;
- tiny-qwen's greedy streams under ``--quant int8``, ``w8a8`` and
  ``int4`` byte-identical to the JAX engine's, on a tie-free weight seed
  per form (3, 3 and 9).  tiny-qwen's bf16 logits tie often (259 logits
  near 2.5 on a 2**-6 grid), and a tie breaks on either side between
  XLA's fused arithmetic and eager PyTorch: at seed 3 under int4 the JAX
  engine's top two logits are equal where the port's differ by one bf16
  step.

The card's own comparison at these shapes is chip_smoke.py's phase 2.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import PRESETS, get_config
from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm
from test_torch_weight_quant import BF16_TOL, _emulate_kernel7

DENSE_PRESETS = sorted(p for p in PRESETS if not get_config(p).n_experts)
QUANT_MODES = {"int8": ("int8", 128), "w8a8": ("w8a8", 128),
               "int4-g128": ("int4", 128), "int4-g8": ("int4", 8),
               "int4-g24": ("int4", 24)}


def _w(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# the fences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(QUANT_MODES))
@pytest.mark.parametrize("preset", DENSE_PRESETS)
def test_model_fence_takes_every_dense_preset(preset, mode):
    quant, gs = QUANT_MODES[mode]
    assert qm.model_fence(get_config(preset), quant, gs) is None


@pytest.mark.parametrize("gs,why", [(0, "even"), (7, "even"), (2**20, "exact")])
def test_shape_fence_refuses_odd_groups_and_inexact_indices(gs, why):
    assert why in qm.shape_fence(4096, "int4", gs)
    assert qm.shape_fence(4096, "int8", gs) is None


# ---------------------------------------------------------------------------
# the padded layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_kernel_layout_pads_tiny_qwens_head(quant):
    engine = InferenceEngine(engine_cfg=EngineConfig(
        model="tiny-qwen", num_slots=2, max_seq=64, quant=quant, quant_group_size=32),
        device="cpu")
    head = engine.params["lm_head"]
    rows = 64 if quant == "int8" else 32  # contracted bytes
    assert tuple(head.q.shape) == (rows, 259)
    assert head.q.stride() == (272, 1)  # 259 bytes padded to 17 pieces
    assert (head.scale.stride(-2) if head.scale.dim() == 2 else 1) in (1, 260)
    # The padding is zeros; the logical region is the quantizer's output.
    padded = torch.as_strided(head.q, (rows, 272), (272, 1))
    assert not padded[:, 259:].any()
    # Laid-out leaves are kept as they are (no second copy).
    again = tq.kernel_layout(engine.params)
    assert again["lm_head"].q is head.q and again["blocks"]["wq"].q is engine.params["blocks"]["wq"].q
    # The wrapper's stride checks: padded rows pass, unpadded rows raise.
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    ldw, lds = qm._check_tensors(x, head.q, head.scale)
    assert ldw == 272 and lds == (259 if quant == "int8" else 260)
    with pytest.raises(ValueError, match="kernel_layout"):
        qm._check_tensors(x, head.q.contiguous(), head.scale)


def test_kernel_layout_pads_a_k_tail_and_keeps_values():
    w = torch.from_numpy(_w((100, 50), 3))
    for leaf in (tq._quantize(w, 1), tq._quantize4(w, -1, 10)):  # NK rows of 50 / 25 bytes
        laid = tq.kernel_layout({"embed": leaf})["embed"]
        assert torch.equal(laid.q, leaf.q) and torch.equal(laid.scale, leaf.scale)
        assert laid.q.stride(0) % 16 == 0 and laid.q.stride(0) >= leaf.q.shape[1]


# ---------------------------------------------------------------------------
# the plain version and the split schedule against JAX
# ---------------------------------------------------------------------------

def _quantized(w, form, layout, gs):
    """(JAX leaf, the port's leaf bridged from it and laid out)."""
    if form == "int4":
        jw = jq._quantize4(jnp.asarray(w), -2 if layout == "kn" else -1, gs)
    else:
        jw = jq._quantize(jnp.asarray(w), 0 if layout == "kn" else 1)
    tw = tt.params_from_numpy({"w": jax.tree.map(np.asarray, jw)}, "cpu")["w"]
    assert tw.q.stride(0) % 16 == 0  # the bridge lays the leaf out
    return jw, tw


def _act(shape, seed):
    jx = jnp.asarray(_w(shape, seed) * 10, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()


#: (form, layout, N, K, group size): tiny-qwen's head (KN, rows of 259
#: bytes), a tied head at a K tail (NK rows of 100 / 50 bytes) and a block
#: projection at a K tail, and int4 groups narrower than a 16-deep k-step.
CASES = [(f, "kn", 259, 64, 32) for f in qm.FORMS] + [
    (f, "nk", 300, 100, 10) for f in qm.FORMS] + [
    (f, "kn", 48, 100, 10) for f in qm.FORMS] + [
    ("int4", layout, 48, 1536, gs) for layout in ("kn", "nk") for gs in (8, 24)]


@pytest.mark.parametrize("form,layout,n,k,gs", CASES)
def test_plain_version_matches_jax(form, layout, n, k, gs):
    w = _w((k, n) if layout == "kn" else (n, k), seed=n + k)
    jw, tw = _quantized(w, form, layout, gs)
    jx, tx = _act((2, 5, k), seed=1)
    aq = form == "w8a8"
    want = np.asarray((jq.mm(jx, jw, aq) if layout == "kn"
                       else jq.head_matmul(jx, jw, aq)).astype(jnp.float32))
    got = tq.mm(tx, tw, aq) if layout == "kn" else tq.head_matmul(tx, tw, aq)
    assert tuple(got.shape) == (2, 5, n)
    if form == "w8a8":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("m", [17, 170])  # the decode plan, the prefill plan
@pytest.mark.parametrize("form,layout,n,k,gs", CASES)
def test_split_schedule_matches_jax(form, layout, n, k, gs, m):
    w = _w((k, n) if layout == "kn" else (n, k), seed=n + k)
    jw, tw = _quantized(w, form, layout, gs)
    jx, tx = _act((m, k), seed=2)
    aq = form == "w8a8"
    want = np.asarray((jq.mm(jx, jw, aq) if layout == "kn"
                       else jq.head_matmul(jx, jw, aq)).astype(jnp.float32))
    got, plan = _emulate_kernel7(tx, tw.q, tw.scale, form, layout,
                                 in_dim=k if form == "int4" else None,
                                 gs=gs if form == "int4" else None)
    assert plan["ldp"] == -(-n // 4) * 4
    if form == "w8a8":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


# ---------------------------------------------------------------------------
# tiny-qwen's streams
# ---------------------------------------------------------------------------

STREAM_ENGINE = dict(model="tiny-qwen", num_slots=4, max_seq=256, dtype="bfloat16",
                     decode_steps=4)
PROMPTS = [list(f"prompt {i}: hello qwen ".encode() * (1 + i)) for i in range(5)]
MAX_NEW = 12


async def _streams(engine):
    await engine.start()
    try:
        async def one(prompt):
            return [ev.token_id async for ev in engine.generate(
                prompt, max_new_tokens=MAX_NEW, stop_ids=())]

        return await asyncio.gather(*[one(p) for p in PROMPTS])
    finally:
        await engine.stop()


@pytest.mark.parametrize("quant,seed", [("int8", 3), ("w8a8", 3), ("int4", 9)])
def test_tiny_qwen_quantized_streams_byte_identical_to_jax(quant, seed):
    jp = jt.init_params(j_get_config("tiny-qwen"), jax.random.PRNGKey(seed), jnp.float32)
    kw = dict(quant=quant, quant_group_size=32)
    want = asyncio.run(_streams(JInferenceEngine(
        engine_cfg=JEngineConfig(**STREAM_ENGINE, **kw), params=jp)))
    engine = InferenceEngine(
        engine_cfg=EngineConfig(**STREAM_ENGINE, **kw),
        params=tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32),
        device="cpu")
    got = asyncio.run(_streams(engine))
    assert got == want and all(len(s) == MAX_NEW for s in got)
    assert engine.params["lm_head"].q.stride(-2) % 16 == 0
