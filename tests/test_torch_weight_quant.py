"""Weight quantization (int8, w8a8, packed int4) in the port against the JAX
package, on the CPU.

- The quantizers (``_quantize``, ``_quantize4``) and the whole-tree
  ``quantize_params`` / ``quantize_params_int4`` are held BIT-EXACT, bytes
  and scales, against the JAX functions run eagerly on identical inputs
  (both divide by a tensor in IEEE f32 and round half to even), at
  contracted widths 33, 64, 128, 130 and 256 and groups 32, 64 and 128.
- Kernel 7's plain version behind ``mm``, ``head_matmul`` and
  ``embed_lookup`` against the JAX functions, every form and both head
  layouts: fp32 within 1e-5; bf16 within one bf16 rounding of the output
  (rtol 2**-7, atol 2**-7 for sums near zero) — the two packages round
  once in the same places, so this bound only absorbs a summation order
  that would land a sum on the other side of a rounding boundary.
- ``params_from_numpy`` carries a quantized JAX tree across unchanged, and
  the port's quantized forwards of the golden synthetic llama meet
  tests/test_golden_logits.py's per-format bounds (w8a8 held to int8's).
- Greedy token streams of the port's engine are byte-identical to the JAX
  engine's at ``--quant int8`` and ``int4`` on the plain loop and on the
  serve defaults with ragged prefill (weight seed 3; the JAX package pins
  its mux path to its plain loop); tests/test_torch_weight_quant_engine.py
  covers w8a8, int8 + ``prefill_act_quant`` and int4 weights with int4 KV,
  fused decode and speculation.
- The engine's construction rules (odd and unknown modes refused, an
  injected int4 tree's group size wins, w8a8 turns ``act_quant`` on) and
  the card's group-size rule (every even size, as the JAX package); the
  CLI's three flags and their env names.
- On CPU tensors kernel 7's wrapper runs its plain version and counts no
  launch; the card-only comparison is marked ``cuda`` and skips here.
"""

import asyncio
import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"
))

from p2p_llm_tunnel_tpu import cli as j_cli
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine
from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.checkpoint import convert_hf
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu_torch import cli
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig, get_config
from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0**-7, rtol=2.0**-7)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "synth_llama_logits.npz")
WEIGHT_SEED = 3  # tie-free for the stream traffic below


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# quantizers, bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [33, 64, 128, 130, 256])
def test_quantize_int8_bit_exact_against_jax(k, dtype):
    w = _w((k, 24), seed=k)
    w[:3, 0] = [127.0, 63.5, -0.5]  # one column with exact midpoints at scale 1
    w[3:, 0] = 0.0
    w[:, 1] = 0.0  # an all-zero column: the 1e-8 scale floor
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    for axis in (0, 1):  # block weights [in, out]; the embedding per row
        got, want = tq._quantize(tw, axis=axis), jq._quantize(jw, axis=axis)
        _eq(got.q, want.q)
        _eq(got.scale, want.scale)
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tq._quantize(tw, axis=0).q[:3, 0].tolist() == [127, 64, 0]


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("k", [33, 64, 128, 130, 256])
def test_quantize4_bit_exact_against_jax(k, gs):
    w = _w((k, 20), seed=k + gs)
    w[:7, 0] = [7.0, 3.5, -2.5, 0.5, 1.5, -7.0, 0.0]  # midpoints at scale 1
    w[7:, 0] = 0.0
    for axis, ww in ((-2, w), (-1, w.T.copy())):
        got = tq._quantize4(torch.from_numpy(ww), axis=axis, group_size=gs)
        want = jq._quantize4(jnp.asarray(ww), axis=axis, group_size=gs)
        _eq(got.q, want.q)
        _eq(got.scale, want.scale)
        assert (got.in_dim, got.group_size, got.axis) == (
            want.in_dim, want.group_size, want.axis)
        assert got.shape == want.shape == ww.shape
    got = tq._quantize4(torch.from_numpy(w), axis=-2, group_size=gs)
    assert tq.unpack_int4(got.q, axis=0)[:4, 0].tolist() == [7, 4, -2, 0]


def test_quantize4_refuses_an_odd_group():
    with pytest.raises(ValueError, match="even"):
        tq._quantize4(torch.zeros(8, 4), axis=0, group_size=5)


def _trees(name, dtype=jnp.float32):
    jcfg = j_get_config(name, vocab_size=300)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                              torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return jp, tp


def _leaves_equal(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _leaves_equal(got[k], want[k])
        return
    if tq.is_quantized(got):
        _eq(got.q, want.q)
        _eq(got.scale, want.scale)
        if isinstance(got, tq.QTensor4):
            assert (got.in_dim, got.group_size, got.axis) == (
                want.in_dim, want.group_size, want.axis)
        return
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])  # untied / tied head
@pytest.mark.parametrize("mode", ["int8", "int4-g32", "int4-g64"])
def test_quantize_params_trees_bit_exact_against_jax(name, mode):
    jp, tp = _trees(name)
    if mode == "int8":
        got, want = tq.quantize_params(tp), jq.quantize_params(jp)
    else:
        gs = int(mode.split("g")[1])
        got, want = tq.quantize_params_int4(tp, gs), jq.quantize_params_int4(jp, gs)
    _leaves_equal(got, want)
    assert ("lm_head" in got) == (name == "tiny")


# ---------------------------------------------------------------------------
# products and the gather (kernel 7's plain version)
# ---------------------------------------------------------------------------

def _act(shape, dtype, seed=1):
    jx = jnp.asarray(_w(shape, seed), getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(FP32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_mm_matches_jax(form, dtype):
    k, n = 130, 40
    w = _w((k, n), seed=5)
    jx, tx = _act((2, 3, k), dtype)
    if form == "int4":
        jw, tw = jq._quantize4(jnp.asarray(w), -2, 32), tq._quantize4(torch.from_numpy(w), -2, 32)
    else:
        jw, tw = jq._quantize(jnp.asarray(w), 0), tq._quantize(torch.from_numpy(w), 0)
    aq = form == "w8a8"
    got, want = tq.mm(tx, tw, aq), jq.mm(jx, jw, aq)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, 3, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_head_matmul_matches_jax(form, dtype):
    v, dm = 72, 33  # odd dm: int4 pads the packed row to a whole group
    e = _w((v, dm), seed=6)
    jx, tx = _act((3, 2, dm), dtype, seed=2)
    if form == "int4":
        je, te = jq._quantize4(jnp.asarray(e), -1, 32), tq._quantize4(torch.from_numpy(e), -1, 32)
    else:
        je, te = jq._quantize(jnp.asarray(e), 1), tq._quantize(torch.from_numpy(e), 1)
    aq = form == "w8a8"
    _close(tq.head_matmul(tx, te, aq), jq.head_matmul(jx, je, aq), dtype)


@pytest.mark.parametrize("form", ["none", "int8", "int4"])
def test_embed_lookup_matches_jax(form):
    e = _w((50, 40), seed=7)
    tokens = np.array([[0, 3, 49], [7, 7, 1]], np.int32)
    if form == "int4":
        je, te = jq._quantize4(jnp.asarray(e), -1, 32), tq._quantize4(torch.from_numpy(e), -1, 32)
    elif form == "int8":
        je, te = jq._quantize(jnp.asarray(e), 1), tq._quantize(torch.from_numpy(e), 1)
    else:
        je, te = jnp.asarray(e, jnp.bfloat16), torch.from_numpy(e).bfloat16()
    got = tq.embed_lookup(te, torch.from_numpy(tokens), torch.bfloat16)
    want = jq.embed_lookup(je, jnp.asarray(tokens), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 40)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_qtensor4_layer_slice_keeps_the_contracted_axis():
    w = _w((3, 40, 12), seed=8)  # [L, in, out], in padded to 64
    t = tq._quantize4(torch.from_numpy(w[0]), -2, 32)
    stack = tq.quantize_params_int4(
        {"blocks": {n: torch.from_numpy(w) for n in tq._BLOCK_WEIGHTS},
         "embed": torch.zeros(4, 32), "final_norm": torch.ones(32)}, 32)["blocks"]["wq"]
    layer = stack[0]
    assert stack.axis == layer.axis == -2 and layer.shape == (40, 12)
    assert tuple(stack.q.shape) == (3, 32, 12) and tuple(stack.scale.shape) == (3, 2, 12)
    _eq(layer.q, np.asarray(t.q))
    x = torch.from_numpy(_w((5, 40), seed=9))
    torch.testing.assert_close(tq.mm(x, layer), x @ tq._dequant4(layer, torch.float32))
    int8 = tq.quantize_params({"blocks": {n: torch.from_numpy(w) for n in tq._BLOCK_WEIGHTS},
                               "embed": torch.zeros(4, 32), "final_norm": torch.ones(32)})
    assert int8["blocks"]["wo"][2].shape == (40, 12)


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    w = tq._quantize4(torch.from_numpy(_w((64, 16), seed=10)), -2, 32)
    x = torch.from_numpy(_w((3, 64), seed=11)).bfloat16()
    before = (qm.quant_matmul.launches, dict(qm.quant_matmul.form_launches))
    got = qm.quant_matmul(x, w.q, w.scale, form="int4", layout="kn", in_dim=64,
                          group_size=32)
    want = qm.plain(x, w.q, w.scale, form="int4", layout="kn", in_dim=64,
                    group_size=32)
    assert torch.equal(got, want)
    assert (qm.quant_matmul.launches, qm.quant_matmul.form_launches) == before


def _emulate_kernel7(x, q, scale, form, layout, in_dim=None, gs=None):
    """Kernel 7's split schedule on the CPU, from ``launch_plan``: each
    split's partial over its K range (f32 products of the kernel's bf16
    operands; w8a8 exact integers), merged in split order, then the form's
    rounding as csrc/quant_matmul.cu's ``store_out`` applies it."""
    m, k = x.shape
    kn = layout == "kn"
    n = q.shape[1] if kn else q.shape[0]
    p = qm.launch_plan(m, n, k, form, layout, gs or 128)
    if form == "w8a8":
        xq, xs = tq._quantize_act(x)
        lhs, w = xq.to(torch.int64), (q if kn else q.T).to(torch.int64)
    elif form == "int4":
        w = tq._dequant4(tq.QTensor4(q, scale, in_dim, gs, -2 if kn else -1), x.dtype)
        lhs, w = x.float(), (w if kn else w.T).float()
    else:
        lhs, w = x.float(), (q if kn else q.T).float()
    total = None
    for k0, k1 in qm.split_ranges(p, k):
        part = lhs[:, k0:k1] @ w[k0:k1]
        total = part if total is None else total + part
    if form == "int8":
        return (total.bfloat16().float() * scale.bfloat16().float()).bfloat16(), p
    if form == "int4":
        return total.bfloat16(), p
    return (total.float() * xs * scale).bfloat16(), p


KERNEL7_CASES = [("int8", "kn", None), ("int8", "nk", None), ("w8a8", "kn", None),
                 ("w8a8", "nk", None)] + [
    ("int4", layout, gs) for layout in ("kn", "nk") for gs in (16, 64, 128)]


@pytest.mark.parametrize("m", [3, 170])  # the decode plan, the prefill plan
@pytest.mark.parametrize("form,layout,gs", KERNEL7_CASES)
def test_kernel7_split_schedule_matches_jax(form, layout, gs, m):
    """The split-K schedule — f32 / integer partials per split, merged in
    split order, rounded once — against the JAX ``mm`` (KN) and
    ``head_matmul`` (NK) on the same seeded inputs: bf16 within one bf16
    rounding, w8a8 BITWISE (its sums are exact in any order); and against
    the port's plain version the same way."""
    k, n = 512, 48
    w = _w((k, n) if layout == "kn" else (n, k), seed=12)
    jx, tx = _act((m, k), "bfloat16", seed=13)
    axis = (-2 if layout == "kn" else -1) if form == "int4" else (0 if layout == "kn" else 1)
    if form == "int4":
        jw, tw = jq._quantize4(jnp.asarray(w), axis, gs), tq._quantize4(torch.from_numpy(w), axis, gs)
    else:
        jw, tw = jq._quantize(jnp.asarray(w), axis), tq._quantize(torch.from_numpy(w), axis)
    aq = form == "w8a8"
    want = jq.mm(jx, jw, aq) if layout == "kn" else jq.head_matmul(jx, jw, aq)
    got, plan = _emulate_kernel7(tx, tw.q, tw.scale, form, layout,
                                 in_dim=k if form == "int4" else None, gs=gs)
    assert plan["splits"] > 1  # the merge is exercised
    assert plan["plan"] == ("decode" if m <= qm.SMALL_MAX_M else "prefill")
    kw = dict(in_dim=k, group_size=gs) if form == "int4" else {}
    plain = qm.plain(tx, tw.q, tw.scale, form=form, layout=layout, **kw)
    if form == "w8a8":
        _eq(got.float(), np.asarray(want, np.float32))
        assert torch.equal(got, plain)
    else:
        _close(got, want, "bfloat16")
        torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)


def test_activation_quantizer_plain_bit_exact_against_jax():
    """The plain version of W8A8's fused activation quantizer (the port's
    ``_quantize_act``, which csrc/quant_matmul.cu's row kernel follows)
    against JAX ``_quantize_act`` run eagerly: int8 values and scales
    bit-exact on rows with ties at .5 (amax 127, so the scale is exactly
    1), an all-zero row (scale 1e-8 / 127) and random rows."""
    k = 64
    rows = _w((6, k), seed=14) * 3.0
    ties = np.zeros(k, np.float32)
    ties[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -126.5]
    rows[0] = ties
    rows[1] = 0.0
    rows[2, :4] = [-127.0, 3.5, -4.5, 100.5]
    rows[2, 4:] = np.clip(rows[2, 4:], -120, 120)
    jx = jnp.asarray(rows, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jq_, js = jq._quantize_act(jx)
    tq_, ts = tq._quantize_act(tx)
    _eq(tq_, jq_)
    _eq(ts, js)
    # Ties went to even, and the zero row quantizes to zeros at 1e-8 / 127.
    assert tq_[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, -126]
    assert tq_[1].abs().sum() == 0 and ts[1, 0] == torch.tensor(1e-8) / 127


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "w8a8", "int4"])
def test_kernel7_matches_its_plain_version_on_the_card(form, cuda_device):
    """On the card (chip_smoke.py phase 2 holds every main-path shape):
    bf16 within chip_smoke's kernel tolerance, w8a8 bitwise (its int32 sums
    are exact)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((17, 4096), generator=g, device=cuda_device).bfloat16()
    w = torch.randn((4096, 1024), generator=g, device=cuda_device)
    wt = tq._quantize4(w, -2, 128) if form == "int4" else tq._quantize(w, 0)
    kw = dict(in_dim=4096, group_size=128) if form == "int4" else {}
    got = qm.quant_matmul(x, wt.q, wt.scale, form=form, **kw)
    want = qm.plain(x, wt.q, wt.scale, form=form, **kw)
    if form == "w8a8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 7 is CUDA C++ and has no "
                    "CPU mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the weight bridge and the golden anchor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_params_from_numpy_carries_a_quantized_jax_tree(mode):
    jp, _ = _trees("tiny-gemma")
    jqp = jq.quantize_params(jp) if mode == "int8" else jq.quantize_params_int4(jp, 32)
    got = tt.params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu", torch.float32)
    want_type = tq.QTensor if mode == "int8" else tq.QTensor4
    assert isinstance(got["blocks"]["w_up"], want_type)
    assert isinstance(got["embed"], want_type)
    assert got["blocks"]["w_up"].q.dtype == torch.int8
    _leaves_equal(got, jqp)


@pytest.fixture(scope="module")
def golden():
    from make_synth_hf_ckpt import fake_llama_state
    from p2p_llm_tunnel_tpu.models.config import ModelConfig as JModelConfig

    fx = np.load(GOLDEN)
    vocab, dim, layers, heads, kv_heads, head_dim, ffn, seed = (int(v) for v in fx["meta"])
    kw = dict(name="synth-golden", vocab_size=vocab, dim=dim, n_layers=layers,
              n_heads=heads, n_kv_heads=kv_heads, head_dim=head_dim,
              ffn_dim=ffn, rope_theta=10000.0, norm_eps=1e-5)
    state = fake_llama_state(types.SimpleNamespace(**kw), seed)
    jp = convert_hf("llama", state, JModelConfig(**kw), jnp.float32)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return ModelConfig(**kw), tp, fx["tokens"], fx["logits"]


#: tests/test_golden_logits.py's per-format bounds: (max, mean, argmax
#: agreement); w8a8 is an int8 format and is held to int8's.
GOLDEN_BOUNDS = {"int8": (0.05, 0.01, 0.85), "w8a8": (0.05, 0.01, 0.85),
                 "int4": (0.6, 0.12, None)}


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_quantized_forward_meets_the_golden_bounds(golden, mode):
    cfg, tp, tokens, want = golden
    if mode == "int4":
        params = tq.quantize_params_int4(tp, 128)
    else:
        params = tq.quantize_params(tp)
        cfg = dataclasses.replace(cfg, act_quant=mode == "w8a8")
    t = torch.from_numpy(tokens.astype(np.int64))[None]
    logits, _, _ = tt.prefill(cfg, params, t, torch.ones_like(t, dtype=torch.bool))
    got = logits[0].numpy()
    max_b, mean_b, agree = GOLDEN_BOUNDS[mode]
    assert np.abs(got - want).max() < max_b
    assert np.abs(got - want).mean() < mean_b
    if agree is not None:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= agree


# ---------------------------------------------------------------------------
# random init directly quantized
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if hasattr(tree, "q"):
        extra = ((tree.in_dim, tree.group_size, tree.axis)
                 if hasattr(tree, "group_size") else ())
        return (tuple(tree.q.shape), str(tree.q.dtype).split(".")[-1],
                tuple(tree.scale.shape), *extra)
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_init_has_the_reference_tree(name, mode):
    jcfg, tcfg = j_get_config(name), get_config(name)
    if mode == "int8":
        want = jax.eval_shape(lambda k: jq._build_params_quantized(jcfg, k),
                              jax.random.PRNGKey(0))
        got = tq.init_params_quantized(tcfg, seed=1, device="cpu")
        scale = jcfg.dim**-0.5 / 127.0
    else:
        want = jax.eval_shape(lambda k: jq._build_params_quantized_int4(jcfg, k, 32),
                              jax.random.PRNGKey(0))
        got = tq.init_params_quantized_int4(tcfg, seed=1, group_size=32, device="cpu")
        scale = jcfg.dim**-0.5 / 7.0
    assert _shapes(got) == _shapes(want)
    wq = got["blocks"]["wq"]
    assert wq.scale.unique().tolist() == [np.float32(scale)]
    lo = -127 if mode == "int8" else -128
    assert int(wq.q.min()) >= lo and wq.q.float().std() > 30


def test_quantized_init_refuses_moe():
    cfg = dataclasses.replace(get_config("tiny"), n_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        tq.init_params_quantized(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tq.init_params_quantized_int4(cfg, device="cpu")


# ---------------------------------------------------------------------------
# engine construction and the CLI
# ---------------------------------------------------------------------------

ENGINE = dict(model="tiny", num_slots=2, max_seq=64, dtype="bfloat16",
              decode_steps=2)


def test_engine_construction_follows_the_reference():
    e = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="w8a8"), device="cpu")
    assert isinstance(e.params["blocks"]["wq"], tq.QTensor) and e.mcfg.act_quant
    e = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="int8",
                                                prefill_act_quant=True), device="cpu")
    assert e._prefill_mcfg.act_quant and not e.mcfg.act_quant
    e = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="int4",
                                                quant_group_size=32), device="cpu")
    assert isinstance(e.params["embed"], tq.QTensor4)
    assert e.params["blocks"]["wq"].group_size == 32 and not e._prefill_mcfg.act_quant
    # An injected int4 tree's group size wins over the config.
    e2 = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="int4"),
                         params=e.params, device="cpu")
    assert e2.ecfg.quant_group_size == 32
    # An injected bf16 tree is quantized once.
    bf16 = tt.init_params(get_config("tiny", vocab_size=259), 0, device="cpu")
    e3 = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="int8"),
                         params=bf16, device="cpu")
    _leaves_equal(e3.params["blocks"]["w_down"], tq.quantize_params(bf16)["blocks"]["w_down"])


@pytest.mark.parametrize("kw,match", [
    (dict(quant="int4", quant_group_size=33), "even"),
    (dict(quant="int3"), "unknown quant mode"),
])
def test_engine_refuses_bad_quant_configs(kw, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(engine_cfg=EngineConfig(**ENGINE, **kw), device="cpu")


@pytest.mark.parametrize("gs,ok", [(16, True), (32, True), (48, True), (64, True),
                                   (128, True), (256, True), (8, True), (24, True),
                                   (30, True), (2, True), (0, False), (33, False)])
def test_group_size_fence_on_the_card(gs, ok):
    """Kernel 7 takes every even int4 group size at llama3-8b's widths,
    as the JAX package serves them; odd and empty groups are refused."""
    why = qm.shape_fence(14336, "int4", gs)
    assert (why is None) == ok
    model = qm.model_fence(get_config("llama3-8b"), "int4", gs)
    assert (model is None) == ok and (ok or why in model and "even" in why)


def test_engine_applies_the_fence_only_on_the_card():
    # The CPU keeps every even group size, as the JAX package does.
    e = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant="int4",
                                                quant_group_size=8), device="cpu")
    assert e.params["blocks"]["wq"].group_size == 8
    # A CUDA engine takes the same weights at construction (model_fence
    # passes), laid out as kernel 7 reads them.
    eng = InferenceEngine.__new__(InferenceEngine)
    eng.ecfg = EngineConfig(**ENGINE, quant="int4", quant_group_size=8)
    eng.mcfg = e.mcfg
    eng.device = torch.device("cuda")
    got = eng._init_weights(e.params, torch.bfloat16)
    assert got["blocks"]["wq"].group_size == 8
    assert got["blocks"]["wq"].q.stride(-2) % 16 == 0


SERVE = ["serve", "--backend", "gpu", "--model", "tiny", "--slots", "4",
         "--max-seq", "128", "--device", "cpu", "--room", "r"]
JSERVE = ["serve", "--backend", "tpu", "--room", "r"]


@pytest.mark.parametrize("flags", [[], ["--quant", "int8", "--prefill-act-quant"],
                                   ["--quant", "w8a8"],
                                   ["--quant", "int4", "--quant-group-size", "64"]])
def test_cli_quant_flags_match_the_jax_cli(flags, monkeypatch):
    for var in ("TUNNEL_QUANT", "TUNNEL_QUANT_GROUP_SIZE", "TUNNEL_PREFILL_ACT_QUANT"):
        monkeypatch.delenv(var, raising=False)
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE + flags))
    jargs = j_cli.build_parser().parse_args(JSERVE + flags)
    assert (ecfg.quant, ecfg.quant_group_size, ecfg.prefill_act_quant) == (
        jargs.quant, jargs.quant_group_size, jargs.prefill_act_quant)


def test_cli_quant_env_defaults(monkeypatch):
    monkeypatch.setenv("TUNNEL_QUANT", "int4")
    monkeypatch.setenv("TUNNEL_QUANT_GROUP_SIZE", "32")
    monkeypatch.setenv("TUNNEL_PREFILL_ACT_QUANT", "1")
    ecfg = cli._engine_config(cli.build_parser().parse_args(SERVE))
    assert (ecfg.quant, ecfg.quant_group_size, ecfg.prefill_act_quant) == ("int4", 32, True)
    ecfg = cli._engine_config(cli.build_parser().parse_args(
        SERVE + ["--no-prefill-act-quant", "--quant", "none"]))
    assert (ecfg.quant, ecfg.prefill_act_quant) == ("none", False)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(SERVE + ["--quant", "int2"])


# ---------------------------------------------------------------------------
# greedy streams against the JAX engine
# ---------------------------------------------------------------------------

STREAM_ENGINE = dict(model="tiny", num_slots=4, max_seq=256, dtype="bfloat16",
                     decode_steps=4)
MUX_RAGGED = dict(mux=True, prefix_cache=True, conv_cache=True, prefill_chunk=32,
                  ragged_prefill=True)
PROMPTS = [list(f"prompt {i}: hello tunnel ".encode() * (1 + i)) for i in range(5)]
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


def jax_streams(quant_kw, seed=WEIGHT_SEED):
    """The JAX engine's plain-loop streams on JAX ``init_params`` weights
    (``seed``), quantized by the engine, and those fp32 weights bridged."""
    jp = jt.init_params(j_get_config("tiny", vocab_size=259),
                        jax.random.PRNGKey(seed), jnp.float32)
    want = asyncio.run(_streams(JInferenceEngine(
        engine_cfg=JEngineConfig(**STREAM_ENGINE, **quant_kw), params=jp)))
    return want, tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                      torch.float32)


def port_streams(params, **kw):
    engine = InferenceEngine(engine_cfg=EngineConfig(**STREAM_ENGINE, **kw),
                             params=params, device="cpu")
    got = asyncio.run(_streams(engine))
    assert engine.config_fences == []
    assert all(len(s) == MAX_NEW for s in got)
    return got, engine


_JAX = {}
STREAM_CASES = {"int8": dict(quant="int8"),
                "int4": dict(quant="int4", quant_group_size=32)}


@pytest.mark.parametrize("path", ["plain", "mux-ragged"])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_greedy_streams_byte_identical_to_jax(case, path):
    kw = STREAM_CASES[case]
    if case not in _JAX:
        _JAX[case] = jax_streams(kw)
    want, params = _JAX[case]
    got, engine = port_streams(params, **kw, **(MUX_RAGGED if path != "plain" else {}))
    assert got == want
    leaf = engine.params["blocks"]["w_gate"]
    assert isinstance(leaf, tq.QTensor4 if case == "int4" else tq.QTensor)
