"""The port's checkpoint module (models/checkpoint.py) against the JAX
package, on the CPU.

- Each HF converter (llama, mixtral, gemma2, qwen2) on the same HF state
  as JAX ``convert_hf``: every leaf BITWISE equal to the JAX tree carried
  over by ``params_from_numpy``, at fp32 and bf16 (both packages round
  f32 to bf16 to nearest even), from numpy leaves and from CPU tensors.
  The llama state is scripts/make_synth_hf_ckpt.fake_llama_state; the
  mixtral, gemma2 and qwen2 states are built the same way (the same
  ``[out, in]`` orientation, 0.02-scaled normals from a seed).
- ``convert_hf(..., quant="int8" | "int4")``: bytes and scales equal to
  JAX's.
- ``save_checkpoint`` / ``load_checkpoint``: a bf16 and an int4 tree round
  trip bitwise; a leaf of another shape or dtype, a missing or an extra
  leaf raises naming it.
- An engine built with ``ckpt_path`` (and the CLI's ``--ckpt``) serves the
  greedy streams the JAX engine serves on the same converted weights,
  byte for byte (fp32, the tiny model's widths, state seed 5, tie-free),
  with bf16 weights quantized once under ``--quant int8`` too.
"""

import asyncio
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"
))

from make_synth_hf_ckpt import fake_llama_state  # noqa: E402
from p2p_llm_tunnel_tpu.engine.engine import EngineConfig as JEngineConfig  # noqa: E402
from p2p_llm_tunnel_tpu.engine.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from p2p_llm_tunnel_tpu.models import checkpoint as jc  # noqa: E402
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config  # noqa: E402
from p2p_llm_tunnel_tpu_torch import cli  # noqa: E402
from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine  # noqa: E402
from p2p_llm_tunnel_tpu_torch.models import checkpoint as tc  # noqa: E402
from p2p_llm_tunnel_tpu_torch.models import quant as tq  # noqa: E402
from p2p_llm_tunnel_tpu_torch.models import transformer as tt  # noqa: E402
from p2p_llm_tunnel_tpu_torch.models.config import get_config  # noqa: E402

VOCAB = 259
STATE_SEED = 5
#: family -> the preset whose widths its state takes.
PRESET = {"llama": "tiny", "mixtral": "tiny-moe", "gemma2": "tiny-gemma",
          "qwen2": "tiny-qwen"}


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def hf_state(family: str, seed: int = STATE_SEED) -> dict:
    """An HF state dict of ``family`` at its preset's widths."""
    cfg = get_config(PRESET[family], vocab_size=VOCAB)
    state = fake_llama_state(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        if family == "mixtral":
            for proj in ("gate_proj", "up_proj", "down_proj"):
                del state[p + f"mlp.{proj}.weight"]
            state[p + "block_sparse_moe.gate.weight"] = _w(rng, cfg.n_experts, cfg.dim)
            for e in range(cfg.n_experts):
                x = p + f"block_sparse_moe.experts.{e}."
                state[x + "w1.weight"] = _w(rng, cfg.ffn_dim, cfg.dim)
                state[x + "w3.weight"] = _w(rng, cfg.ffn_dim, cfg.dim)
                state[x + "w2.weight"] = _w(rng, cfg.dim, cfg.ffn_dim)
        if family == "gemma2":
            for norm in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
                state[p + norm + ".weight"] = _w(rng, cfg.dim)
        if family == "qwen2":
            for proj, width in (("q_proj", cfg.n_heads), ("k_proj", cfg.n_kv_heads),
                                ("v_proj", cfg.n_kv_heads)):
                state[p + f"self_attn.{proj}.bias"] = _w(rng, width * cfg.head_dim)
    if family == "gemma2":
        del state["lm_head.weight"]
    return state


def _jax_tree(family, state, dtype, **kw):
    jcfg = j_get_config(PRESET[family], vocab_size=VOCAB)
    jp = jc.convert_hf(family, state, jcfg, jnp.dtype(dtype), **kw)
    return jax.tree.map(np.asarray, jp)


def _leaves(tree, where=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{where}/{k}")
    elif tq.is_quantized(tree):
        yield where + ".q", tree.q
        yield where + ".scale", tree.scale
    else:
        yield where, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert torch.equal(g[name], w[name]), name


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(tc.CONVERTERS))
def test_converter_matches_jax(family, dtype):
    state = hf_state(family)
    cfg = get_config(PRESET[family], vocab_size=VOCAB)
    got = tc.convert_hf(family, state, cfg, getattr(torch, dtype), device="cpu")
    want = tt.params_from_numpy(_jax_tree(family, state, dtype), "cpu",
                                getattr(torch, dtype))
    _assert_trees_equal(got, want)
    # The tree the config builds: the converted weights serve as they are.
    like = tt.init_params(cfg, 0, getattr(torch, dtype), "meta")
    tc._check_like(tc._pack(got), like)


def test_converter_takes_cpu_tensors():
    state = hf_state("qwen2")
    cfg = get_config("tiny-qwen", vocab_size=VOCAB)
    tensors = {k: torch.from_numpy(v).bfloat16() for k, v in state.items()}
    got = tc.convert_hf("qwen2", tensors, cfg, device="cpu")
    want = tc.convert_hf("qwen2", {k: v.float().numpy() for k, v in tensors.items()},
                         cfg, device="cpu")
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_conversion_bytes_equal_jax(quant, dtype):
    state = hf_state("llama")
    cfg = get_config("tiny", vocab_size=VOCAB)
    got = tc.convert_hf("llama", state, cfg, getattr(torch, dtype), quant=quant,
                        group_size=32, device="cpu")
    want = tt.params_from_numpy(
        _jax_tree("llama", state, dtype, quant=quant, group_size=32), "cpu",
        getattr(torch, dtype))
    _assert_trees_equal(got, want)
    assert isinstance(got["blocks"]["wq"], tq.QTensor4 if quant == "int4" else tq.QTensor)


def test_unknown_family_and_quant_raise():
    cfg = get_config("tiny", vocab_size=VOCAB)
    with pytest.raises(KeyError, match="unknown family"):
        tc.convert_hf("gpt2", {}, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown quant"):
        tc.convert_hf("llama", hf_state("llama"), cfg, quant="int3", device="cpu")


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int4"])
def test_save_load_round_trip(tmp_path, quant):
    cfg = get_config("tiny", vocab_size=VOCAB)
    params = tc.convert_hf("llama", hf_state("llama"), cfg, quant=quant,
                           group_size=32, device="cpu")
    params = tq.kernel_layout(params)  # padded views save and load as views
    tc.save_checkpoint(str(tmp_path / "ckpt"), params)
    assert os.listdir(tmp_path / "ckpt") == [tc.CKPT_FILE]
    like = tt.init_params(cfg, 0, torch.bfloat16, "meta") if quant == "none" else None
    got = tc.load_checkpoint(str(tmp_path / "ckpt"), like=like, device="cpu")
    _assert_trees_equal(got, params)
    if quant == "int4":
        head = got["lm_head"]
        assert (head.in_dim, head.group_size, head.axis) == (cfg.dim, 32, -2)


def _broken(tree, case):
    if case == "shape":
        tree["blocks"]["wq"] = tree["blocks"]["wq"][:, :, :8]
        return "blocks/wq"
    if case == "dtype":
        tree["final_norm"] = tree["final_norm"].float()
        return "final_norm"
    if case == "missing":
        del tree["blocks"]["w_up"]
        return "blocks/w_up"
    tree["blocks"]["extra"] = tree["final_norm"]
    return "blocks/extra"


@pytest.mark.parametrize("case", ["shape", "dtype", "missing", "extra"])
def test_load_refuses_a_tree_the_config_does_not_build(tmp_path, case):
    cfg = get_config("tiny", vocab_size=VOCAB)
    params = tc.convert_hf("llama", hf_state("llama"), cfg, device="cpu")
    leaf = _broken(params, case)
    tc.save_checkpoint(str(tmp_path), params)
    like = tt.init_params(cfg, 0, torch.bfloat16, "meta")
    with pytest.raises(ValueError, match=f"checkpoint leaf {leaf}"):
        tc.load_checkpoint(str(tmp_path), like=like, device="cpu")


def test_load_refuses_a_quantized_file_for_a_bf16_tree(tmp_path):
    cfg = get_config("tiny", vocab_size=VOCAB)
    tc.save_checkpoint(str(tmp_path), tc.convert_hf(
        "llama", hf_state("llama"), cfg, quant="int8", device="cpu"))
    with pytest.raises(ValueError, match="int8 quantized leaf"):
        tc.load_checkpoint(str(tmp_path), like=tt.init_params(cfg, 0, torch.bfloat16,
                                                              "meta"), device="cpu")


# ---------------------------------------------------------------------------
# the engine with --ckpt
# ---------------------------------------------------------------------------

ENGINE = dict(model="tiny", num_slots=4, max_seq=256, dtype="float32", decode_steps=4)
PROMPTS = [list(f"prompt {i}: hello checkpoint ".encode() * (1 + i)) for i in range(5)]
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


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_ckpt_engine_streams_byte_identical_to_jax(tmp_path, quant):
    """convert_hf -> save_checkpoint -> an engine with ckpt_path, against
    the JAX engine fed JAX convert_hf's weights (under --quant int8 both
    engines quantize the bf16 tree once)."""
    state = hf_state("llama")
    cfg = get_config("tiny", vocab_size=VOCAB)
    tc.save_checkpoint(str(tmp_path), tc.convert_hf("llama", state, cfg, torch.float32,
                                                    device="cpu"))
    want = asyncio.run(_streams(JInferenceEngine(
        engine_cfg=JEngineConfig(**ENGINE, quant=quant),
        params=jc.convert_hf("llama", state, j_get_config("tiny", vocab_size=VOCAB),
                             jnp.float32))))
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE, quant=quant,
                                                     ckpt_path=str(tmp_path)),
                             device="cpu")
    got = asyncio.run(_streams(engine))
    assert got == want and all(len(s) == MAX_NEW for s in got)
    if quant == "int8":
        assert isinstance(engine.params["blocks"]["wq"], tq.QTensor)


def test_cli_ckpt_builds_the_engine_on_the_saved_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("TUNNEL_CKPT", raising=False)
    cfg = get_config("tiny", vocab_size=VOCAB)
    params = tc.convert_hf("llama", hf_state("llama"), cfg, torch.float32, device="cpu")
    tc.save_checkpoint(str(tmp_path), params)
    args = cli.build_parser().parse_args([
        "serve", "--backend", "gpu", "--model", "tiny", "--slots", "2",
        "--max-seq", "64", "--dtype", "float32", "--device", "cpu", "--room", "r",
        "--ckpt", str(tmp_path)])
    engine = InferenceEngine(engine_cfg=cli._engine_config(args), device="cpu")
    _assert_trees_equal(engine.params, params)
