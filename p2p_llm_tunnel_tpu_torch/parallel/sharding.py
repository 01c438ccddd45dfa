"""Sharding rules for the stacked-layer params tree and the KV cache (port
of p2p_llm_tunnel_tpu/parallel/sharding.py).

The spec table is the reference's, as tuples of axis names (``None`` =
replicated along that axis):

- column-parallel ``wq/wk/wv/w_gate/w_up`` and the biases ``bq/bk/bv``
  shard their OUTPUT feature axis on ``tp`` — each rank computes its own
  heads / FFN slice with no communication;
- row-parallel ``wo/w_down`` shard their INPUT feature axis — the model
  sums the partial products with one ``all_reduce`` per block half, the
  psum GSPMD inserts from these specs;
- ``embed [V, Dm]`` and ``lm_head [Dm, V]`` shard on vocab: a masked
  lookup plus an ``all_reduce``, and vocab-sharded logits gathered to full
  width before sampling;
- norms replicate; MoE experts shard their expert axis on ``ep`` (a rank
  holds experts ``[e*E/ep, (e+1)*E/ep)``, replicated under tp), the router
  replicates; every other leaf replicates over ep and dp;
- the KV cache ``[L, B, S, K, D]`` and its ``[L, B, S, K]`` scale planes
  shard the kv-head axis on tp and the slot axis on dp (a rank holds the
  rows of its own slots).

Where JAX places a tree on the mesh (``jax.device_put``), the port slices
this rank's shard out of a full tree (``shard_params``), or out of the
reference's tree as numpy (``params_from_numpy_sharded``), so tests feed
both packages the same weights.  Quantized leaves shard congruently: an
int8 scale takes the weight's spec minus the contracted axis (replicated
for a row-parallel weight), an int4 scale the weight's spec verbatim —
and a row-parallel int4 weight's K/tp must be a whole number of groups.
Each shard is then laid out as kernel 7 reads it (``quant.kernel_layout``)
at its own N and K.  A sharded axis must divide by its mesh axis, as
JAX's ``device_put`` requires.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.models.quant import QTensor, QTensor4, kernel_layout
from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]

#: Contracted (quantization) axis per weight name, as the reference: the
#: int8 scale drops exactly this axis.
_QUANT_AXIS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 1,
    "w_gate": 1, "w_up": 1, "w_down": 1,
    "embed": 1, "lm_head": 0,
}


def _qspec(weight_spec: Spec, name: str) -> QTensor:
    """Spec pair of an int8 leaf: ``q`` like the weight, ``scale`` the
    weight's spec with the contracted axis dropped."""
    axis = _QUANT_AXIS[name]
    return QTensor(q=weight_spec,
                   scale=tuple(s for i, s in enumerate(weight_spec) if i != axis))


def _qspec4(weight_spec: Spec, leaf: QTensor4) -> QTensor4:
    """Spec pair of a packed int4 leaf: ``q`` and ``scale`` (same rank as
    the weight, contracted axis -> groups) both take the weight's spec."""
    return QTensor4(q=weight_spec, scale=weight_spec, in_dim=leaf.in_dim,
                    group_size=leaf.group_size, axis=leaf.axis)


def moe_pspecs() -> Dict[str, Spec]:
    """MoE leaves: experts shard on ``ep``, the router replicates."""
    return {
        "router": (None, None, None),
        "moe_gate": (None, "ep", None, None),
        "moe_up": (None, "ep", None, None),
        "moe_down": (None, "ep", None, None),
    }


def param_pspecs(cfg: ModelConfig, params: Optional[dict] = None) -> Dict[str, Any]:
    """Spec tree matching ``init_params``' layout; with ``params``, quantized
    leaves get congruent ``QTensor``/``QTensor4`` spec pairs."""

    def maybe_q(name: str, spec: Spec, leaf) -> Any:
        if isinstance(leaf, QTensor):
            return _qspec(spec, name)
        if isinstance(leaf, QTensor4):
            return _qspec4(spec, leaf)
        return spec

    pblocks = params["blocks"] if params is not None else {}
    blocks: Dict[str, Any] = {
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
    }
    if cfg.n_experts:
        blocks.update(moe_pspecs())
    else:
        blocks.update({
            "w_gate": (None, None, "tp"),
            "w_up": (None, None, "tp"),
            "w_down": (None, "tp", None),
        })
    for name in _QUANT_AXIS:
        if name in blocks:
            blocks[name] = maybe_q(name, blocks[name], pblocks.get(name))
    if cfg.post_norms:
        blocks["post_attn_norm"] = (None, None)
        blocks["post_mlp_norm"] = (None, None)
    if cfg.attn_bias:
        blocks["bq"] = (None, "tp")
        blocks["bk"] = (None, "tp")
        blocks["bv"] = (None, "tp")
    specs: Dict[str, Any] = {
        "embed": maybe_q("embed", ("tp", None),
                         params.get("embed") if params is not None else None),
        "blocks": blocks,
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = maybe_q(
            "lm_head", (None, "tp"),
            params.get("lm_head") if params is not None else None)
    return specs


def kv_cache_pspecs(kv_cache: Optional[dict] = None) -> Dict[str, Spec]:
    """``[L, Slots, S, K, D]``: slots on dp, kv heads on tp; the quantized
    caches' ``[L, Slots, S, K]`` scale planes shard congruently."""
    spec: Spec = (None, "dp", None, "tp", None)
    scale_spec: Spec = (None, "dp", None, "tp")
    if kv_cache is None:
        return {"k": spec, "v": spec}
    return {name: (spec if leaf.ndim == 5 else scale_spec)
            for name, leaf in kv_cache.items()}


def _shard(x, spec: Spec, mesh: Mesh, what: str):
    """This rank's block of ``x`` (a numpy array or a tensor) under
    ``spec``: each axis named ``tp``, ``ep``, ``dp`` or ``sp`` cut into that
    mesh axis's size of equal blocks, this rank's coordinate picking one."""
    idx = []
    for axis, name in enumerate(spec):
        parts = 1 if name is None else mesh.shape[name]
        if parts == 1:
            idx.append(slice(None))
            continue
        n = x.shape[axis]
        if n % parts:
            raise ValueError(
                f"{what} {tuple(x.shape)}: axis {axis} of size {n} does not "
                f"divide over {name}={parts}"
            )
        w, c = n // parts, mesh.coord(name)
        idx.append(slice(c * w, (c + 1) * w))
    out = x[tuple(idx)]
    if isinstance(out, np.ndarray):
        return np.ascontiguousarray(out)
    return out.contiguous()


def _int4_row_shard_fence(leaf, spec: Spec, mesh: Mesh, what: str) -> int:
    """The in_dim of a QTensor4 shard; refuses a contracted axis cut on tp
    into pieces that are not whole groups."""
    axis = leaf.axis % len(spec)
    if spec[axis] != "tp" or mesh.tp == 1:
        return int(leaf.in_dim)
    k, gs = int(leaf.in_dim), int(leaf.group_size)
    if k % (gs * mesh.tp):
        raise ValueError(
            f"{what}: int4 weight of logical shape "
            f"{tuple(leaf.q.shape[:axis]) + (k,) + tuple(leaf.q.shape[axis + 1:])} "
            f"is row-parallel (K {k} cut on tp={mesh.tp}), but K/tp = "
            f"{k / mesh.tp:g} is not a whole number of {gs}-position groups"
        )
    return k // mesh.tp


def _shard_tree(tree, specs, mesh: Mesh, path: str, qtypes):
    """Slice every leaf of ``tree`` by ``specs``; quantized leaves (of the
    classes ``qtypes`` = (int8 class, int4 class) or attribute-alike
    objects) shard ``q`` and ``scale`` congruently."""
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs[k], mesh, f"{path}{k}" if not path
                               else f"{path}.{k}", qtypes)
                for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        if hasattr(tree, "group_size"):
            in_dim = _int4_row_shard_fence(tree, specs.q, mesh, path)
            return qtypes[1](_shard(tree.q, specs.q, mesh, path + ".q"),
                             _shard(tree.scale, specs.scale, mesh, path + ".scale"),
                             in_dim, int(tree.group_size), int(tree.axis))
        return qtypes[0](_shard(tree.q, specs.q, mesh, path + ".q"),
                         _shard(tree.scale, specs.scale, mesh, path + ".scale"))
    return _shard(tree, specs, mesh, path)


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """This rank's shard of a full (possibly int8 or int4) params tree,
    each quantized shard laid out as kernel 7 reads it.  The full tree is
    left as it was; the shard's leaves are fresh contiguous tensors."""
    specs = param_pspecs(cfg, params)
    return kernel_layout(_shard_tree(params, specs, mesh, "", (QTensor, QTensor4)))


def _np_int8(q, scale):
    return SimpleNamespace(q=q, scale=scale)


def _np_int4(q, scale, in_dim, group_size, axis):
    return SimpleNamespace(q=q, scale=scale, in_dim=in_dim,
                           group_size=group_size, axis=axis)


def params_from_numpy_sharded(tree, cfg: ModelConfig, mesh: Mesh, device,
                              dtype=torch.bfloat16) -> dict:
    """The sharded form of ``transformer.params_from_numpy``: the reference's
    params tree as numpy (quantized leaves recognised by their attributes)
    -> this rank's shard in this package's layout, sliced on the host
    before anything moves to ``device``."""
    from p2p_llm_tunnel_tpu_torch.models.transformer import params_from_numpy

    def like(leaf):  # the port's spec pairs read QTensor/QTensor4 classes
        if isinstance(leaf, dict):
            return {k: like(v) for k, v in leaf.items()}
        if hasattr(leaf, "group_size"):
            return QTensor4(leaf.q, leaf.scale, int(leaf.in_dim),
                            int(leaf.group_size), int(leaf.axis))
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            return QTensor(leaf.q, leaf.scale)
        return leaf

    specs = param_pspecs(cfg, like(tree))
    sliced = _shard_tree(tree, specs, mesh, "", (_np_int8, _np_int4))
    return params_from_numpy(sliced, device, dtype)


def shard_kv_cache(kv_cache: dict, mesh: Mesh) -> dict:
    """This rank's block of a full cache: its kv heads under tp, its slots'
    rows under dp (``kv_cache_pspecs``)."""
    specs = kv_cache_pspecs(kv_cache)
    return {name: _shard(leaf, specs[name], mesh, name)
            for name, leaf in kv_cache.items()}


def local_kv_heads(cfg: ModelConfig, mesh: Optional[Mesh]) -> int:
    """The kv heads one rank's cache holds (``n_kv_heads / tp``)."""
    tp = mesh.tp if mesh is not None else 1
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"{cfg.name}: {cfg.n_heads} query / {cfg.n_kv_heads} kv heads do "
            f"not divide over tp={tp}"
        )
    return cfg.n_kv_heads // tp
