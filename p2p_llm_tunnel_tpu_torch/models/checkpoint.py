"""Checkpoint save/load and HuggingFace weight conversion — the port's
counterpart of p2p_llm_tunnel_tpu/models/checkpoint.py.

The converters map an HF state dict (per-layer names, ``[out, in]``
projections) onto the stacked-layer tree of ``models/transformer``'s
``init_params`` (every block tensor ``[n_layers, ...]``, projections
transposed to ``x @ W``), optionally quantized on the way in.  They are
this package's own copy: the port imports nothing of the JAX package.

The file format differs from the reference's on purpose: the card has no
jax, orbax or tensorstore, so ``save_checkpoint`` writes the param tree
with ``torch.save`` (one ``params.pt`` in the checkpoint directory) and
``load_checkpoint`` reads it back memory-mapped with
``torch.load(weights_only=True, mmap=True)``, checking every leaf against
the tree the config would build, as the reference's ``like=`` does.  A
JAX orbax directory is not readable here; the operator's route mirrors
the JAX package's: ``convert_hf`` -> ``save_checkpoint`` -> ``--ckpt``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.models.quant import (
    QTensor,
    QTensor4,
    quantize_params,
    quantize_params_int4,
)
from p2p_llm_tunnel_tpu_torch.models.transformer import resolve_device
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

Params = Dict[str, Any]
#: The file a checkpoint directory holds.
CKPT_FILE = "params.pt"


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _pack(tree):
    """The tree in what ``torch.load(weights_only=True)`` reads back:
    quantized leaves as dicts of their tensors and integers."""
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, QTensor4):
        return {"__quant__": "int4", "q": tree.q, "scale": tree.scale,
                "in_dim": tree.in_dim, "group_size": tree.group_size,
                "axis": tree.axis}
    if isinstance(tree, QTensor):
        return {"__quant__": "int8", "q": tree.q, "scale": tree.scale}
    return tree


def _unpack(tree, device):
    if isinstance(tree, dict):
        kind = tree.get("__quant__")
        if kind == "int4":
            return QTensor4(tree["q"].to(device), tree["scale"].to(device),
                            tree["in_dim"], tree["group_size"], tree["axis"])
        if kind == "int8":
            return QTensor(tree["q"].to(device), tree["scale"].to(device))
        return {k: _unpack(v, device) for k, v in tree.items()}
    return tree.to(device)


def save_checkpoint(path: str, params: Params) -> None:
    """Write a param tree (bf16 or quantized leaves) into the directory
    ``path`` as ``params.pt``, atomically (a temporary file renamed)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CKPT_FILE + ".tmp")
    torch.save(_pack(params), tmp)
    os.replace(tmp, os.path.join(path, CKPT_FILE))
    log.info("saved checkpoint to %s", path)


def _check_like(tree, like, where: str = "") -> None:
    """Raise naming the first leaf whose presence, shape or dtype differs
    from ``like`` (a tree of tensors, on the meta device or any other)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or "__quant__" in tree:
            raise ValueError(f"checkpoint leaf {where or '/'}: expected a "
                             f"subtree, the file holds {_describe(tree)}")
        for key in sorted(set(like) | set(tree)):
            name = f"{where}/{key}" if where else key
            if key not in tree:
                raise ValueError(f"checkpoint leaf {name}: missing from the file")
            if key not in like:
                raise ValueError(f"checkpoint leaf {name}: not in the config's tree")
            _check_like(tree[key], like[key], name)
        return
    if not isinstance(tree, torch.Tensor) or (
            tuple(tree.shape), tree.dtype) != (tuple(like.shape), like.dtype):
        raise ValueError(
            f"checkpoint leaf {where}: the file holds {_describe(tree)}, the "
            f"config's tree {like.dtype} {tuple(like.shape)}")


def _describe(leaf) -> str:
    if isinstance(leaf, dict):
        kind = leaf.get("__quant__")
        return f"an {kind} quantized leaf" if kind else "a subtree"
    return f"{leaf.dtype} {tuple(leaf.shape)}"


def load_checkpoint(path: str, like: Optional[Params] = None,
                    device=None) -> Params:
    """Read a ``save_checkpoint`` directory onto ``device`` (the card when
    None).  ``like`` (e.g. ``init_params(cfg, dtype=..., device="meta")``,
    which allocates nothing) pins every leaf's shape and dtype: a leaf
    missing, extra, or of another shape or dtype raises ValueError naming
    it, before anything is copied to the device."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    if like is not None:
        _check_like(tree, like)
    return _unpack(tree, dev)


# ---------------------------------------------------------------------------
# HF state-dict conversion
# ---------------------------------------------------------------------------

def _host(x) -> torch.Tensor:
    """An HF leaf (numpy array, bf16 numpy included, or tensor) as a CPU
    tensor, without a copy where none is needed."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact in f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _stack(tensors, dtype, device) -> torch.Tensor:
    return torch.stack([t.to(device=device, dtype=dtype) for t in tensors])


def _leaf(x, dtype, device) -> torch.Tensor:
    return _host(x).to(device=device, dtype=dtype).contiguous()


def _head(state, cfg: ModelConfig, dtype, device, params: Params) -> Params:
    if not cfg.tie_embeddings:
        head = state.get("lm_head.weight")
        if head is None:  # some exports tie implicitly
            head = state["model.embed_tokens.weight"]
        params["lm_head"] = _leaf(_host(head).T, dtype, device)
    return params


def convert_hf_llama(state: Mapping[str, Any], cfg: ModelConfig,
                     dtype=torch.bfloat16, device=None) -> Params:
    """HF Llama layout -> stacked tree: per-layer ``[out, in]`` projections
    transposed to ``x @ W`` and stacked on a leading layer axis."""
    dev = resolve_device(device)
    l = cfg.n_layers

    def w(name: str, i: int) -> torch.Tensor:
        return _host(state[f"model.layers.{i}.{name}.weight"])

    def stack(name: str, t: bool = True) -> torch.Tensor:
        return _stack([w(name, i).T if t else w(name, i) for i in range(l)],
                      dtype, dev)

    blocks = {
        "attn_norm": stack("input_layernorm", t=False),
        "mlp_norm": stack("post_attention_layernorm", t=False),
        "wq": stack("self_attn.q_proj"),
        "wk": stack("self_attn.k_proj"),
        "wv": stack("self_attn.v_proj"),
        "wo": stack("self_attn.o_proj"),
        "w_gate": stack("mlp.gate_proj"),
        "w_up": stack("mlp.up_proj"),
        "w_down": stack("mlp.down_proj"),
    }
    params: Params = {
        "embed": _leaf(state["model.embed_tokens.weight"], dtype, dev),
        "blocks": blocks,
        "final_norm": _leaf(state["model.norm.weight"], dtype, dev),
    }
    return _head(state, cfg, dtype, dev, params)


def convert_hf_mixtral(state: Mapping[str, Any], cfg: ModelConfig,
                       dtype=torch.bfloat16, device=None) -> Params:
    """HF Mixtral layout -> stacked MoE tree: attention as llama;
    ``block_sparse_moe.gate`` -> router and ``experts.{e}.w1/w3/w2`` ->
    moe_gate/moe_up/moe_down, stacked ``[L, E, ...]`` (models/moe.py)."""
    dev = resolve_device(device)
    l, e = cfg.n_layers, cfg.n_experts

    def w(name: str, i: int) -> torch.Tensor:
        return _host(state[f"model.layers.{i}.{name}.weight"])

    def stack(name: str, t: bool = True) -> torch.Tensor:
        return _stack([w(name, i).T if t else w(name, i) for i in range(l)],
                      dtype, dev)

    def experts(proj: str) -> torch.Tensor:
        return _stack([_stack([w(f"block_sparse_moe.experts.{x}.{proj}", i).T
                               for x in range(e)], dtype, dev) for i in range(l)],
                      dtype, dev)

    blocks = {
        "attn_norm": stack("input_layernorm", t=False),
        "mlp_norm": stack("post_attention_layernorm", t=False),
        "wq": stack("self_attn.q_proj"),
        "wk": stack("self_attn.k_proj"),
        "wv": stack("self_attn.v_proj"),
        "wo": stack("self_attn.o_proj"),
        "router": stack("block_sparse_moe.gate"),
        "moe_gate": experts("w1"),
        "moe_up": experts("w3"),
        "moe_down": experts("w2"),
    }
    params: Params = {
        "embed": _leaf(state["model.embed_tokens.weight"], dtype, dev),
        "blocks": blocks,
        "final_norm": _leaf(state["model.norm.weight"], dtype, dev),
    }
    return _head(state, cfg, dtype, dev, params)


def convert_hf_gemma2(state: Mapping[str, Any], cfg: ModelConfig,
                      dtype=torch.bfloat16, device=None) -> Params:
    """HF Gemma-2 layout -> stacked tree: llama's transposes, pre/post
    norms per sub-block (attn/mlp norms + post_* norms), tied embeddings
    (no lm_head)."""
    dev = resolve_device(device)
    l = cfg.n_layers

    def stack(name: str, t: bool = True) -> torch.Tensor:
        ws = [_host(state[f"model.layers.{i}.{name}.weight"]) for i in range(l)]
        return _stack([x.T if t else x for x in ws], dtype, dev)

    blocks = {
        "attn_norm": stack("input_layernorm", t=False),
        "post_attn_norm": stack("post_attention_layernorm", t=False),
        "mlp_norm": stack("pre_feedforward_layernorm", t=False),
        "post_mlp_norm": stack("post_feedforward_layernorm", t=False),
        "wq": stack("self_attn.q_proj"),
        "wk": stack("self_attn.k_proj"),
        "wv": stack("self_attn.v_proj"),
        "wo": stack("self_attn.o_proj"),
        "w_gate": stack("mlp.gate_proj"),
        "w_up": stack("mlp.up_proj"),
        "w_down": stack("mlp.down_proj"),
    }
    return {
        "embed": _leaf(state["model.embed_tokens.weight"], dtype, dev),
        "blocks": blocks,
        "final_norm": _leaf(state["model.norm.weight"], dtype, dev),
    }


def convert_hf_qwen2(state: Mapping[str, Any], cfg: ModelConfig,
                     dtype=torch.bfloat16, device=None) -> Params:
    """HF Qwen2 layout -> stacked tree: llama's mapping plus the QKV biases
    (``self_attn.{q,k,v}_proj.bias``), which llama lacks."""
    dev = resolve_device(device)
    params = convert_hf_llama(state, cfg, dtype, dev)
    for name, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
        params["blocks"][name] = _stack(
            [_host(state[f"model.layers.{i}.self_attn.{proj}.bias"])
             for i in range(cfg.n_layers)], dtype, dev)
    return params


CONVERTERS = {
    "llama": convert_hf_llama,
    "gemma2": convert_hf_gemma2,
    "mixtral": convert_hf_mixtral,
    "qwen2": convert_hf_qwen2,
}


def convert_hf(family: str, state: Mapping[str, Any], cfg: ModelConfig,
               dtype=torch.bfloat16, quant: str = "none", group_size: int = 128,
               device=None) -> Params:
    """HF state dict -> stacked tree on ``device`` (the card when None),
    optionally quantized on the way in: ``"int8"`` (``quantize_params``) or
    ``"int4"`` (``quantize_params_int4`` at ``group_size``), so a loader of
    a big checkpoint can drop the bf16 tree at once.  The engine quantizes
    a loaded bf16 tree itself under ``--quant``."""
    if family not in CONVERTERS:
        raise KeyError(f"unknown family {family!r}; have {sorted(CONVERTERS)}")
    params = CONVERTERS[family](state, cfg, dtype, device)
    if quant == "int8":
        return quantize_params(params)
    if quant == "int4":
        return quantize_params_int4(params, group_size=group_size)
    if quant not in ("none", ""):
        raise ValueError(f"unknown quant mode {quant!r}")
    return params
