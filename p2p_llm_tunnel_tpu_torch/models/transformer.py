"""Decoder-only transformer (llama/gemma families) in plain PyTorch — the
port of p2p_llm_tunnel_tpu/models/transformer.py, the subset the serve
CLI's default engine (mux, prefix pool, conversation cache) and the plain
non-mux loop run: random init, the ``[L, B, S, K, D]`` KV cache (raw, int8
with per-(token, head) scales, or int4 packed two tokens per byte along
the sequence axis), prefill (whole prompts, batched), tail prefill against
reused history (``chunk_prefill_into_cache``, einsum attention as in the
reference), the ragged grouped tail prefill (``ragged_prefill_into_cache``,
one kernel-6 launch per layer), one-token-per-slot decode, unfused
(kernel 2) or through the fused decode layer (kernel 4, one launch per
layer), the speculative verify burst (``spec_verify_into_cache``:
kernel 5 fused, the chunk path otherwise), mean-pooled embeddings
(``encode_pooled``), mixture-of-experts MLPs (``models/moe``) and the
training objective (``loss_fn``).

Idiom differences from the JAX reference, all deliberate:

- the layer loop is a Python loop over per-layer views of the stacked
  ``[L, ...]`` weights where JAX uses ``lax.scan``;
- the KV cache is MUTATED IN PLACE (JAX rebuilt it functionally and let
  XLA alias the buffers); every function that writes it says so and still
  returns it, so call sites read like the reference's;
- prefill and decode attention go through the kernel wrappers
  (``ops/flash_attention``, ``ops/decode_attention``,
  ``ops/prefill_attention``): on CUDA tensors they launch the Hopper
  kernels, on CPU tensors they run the plain versions;
  ``chunk_prefill_into_cache`` runs ``ops/attention.history_attention`` on
  either device, as the reference runs einsum attention there.
  ``ModelConfig.flash``/``flash_decode`` pick between XLA and Pallas on a
  TPU and choose nothing here; ``fused_decode_layer`` picks kernel 4 over
  kernel 2 for decode (``ops/fused_decode``), on the card and, as its
  plain version, on the CPU.
- quantized KV writes are plain torch ops (the reference's are XLA ops
  outside any Pallas kernel) through ``models/quant``'s whole-byte helpers;
- quantized weights (``models/quant.QTensor``/``QTensor4`` leaves, every
  matmul weight and the embedding) go through ``quant.mm`` and
  ``quant.head_matmul`` — kernel 7 on the card, its plain version on the
  CPU — and a quantized embedding gathers into bf16 activations, as in
  the reference; ``cfg.act_quant`` runs the W8A8 products;
- tensor parallelism (a ``parallel/mesh`` value as ``mesh``): the
  collectives GSPMD inserts from the reference's shardings are written
  out — each rank computes its H/tp query and K/tp kv heads (kernels 1
  and 2 per head shard, as the reference's ``flash_tp``), an
  ``all_reduce`` sums the row-parallel ``wo`` and ``w_down`` partials,
  the embedding is a vocab-parallel lookup, and the vocab-sharded logits
  are gathered to full width before sampling.  As the reference's
  ``kernel_ok``, the fused decode layer and the fused verify burst run at
  tp 1 only;
- sequence parallelism (a mesh with sp > 1): each rank carries its own
  sequence block ``[B, T/sp]`` of a prefill through every block, with
  rope at its global positions; attention is ring attention
  (``ops/ring_attention``) or Ulysses (``ops/ulysses_attention``, kernel 1
  over the whole sequence at H/sp heads) by ``cfg.sp_mode``, the
  reference's ``_prefill_attention_fn``.  The hidden states are gathered
  over sp before the final norm and the head, and each layer's K/V before
  it is written: the cache is replicated over sp (the reference's
  ``kv_cache_pspecs`` has no sp axis), so decode is unchanged;
- expert parallelism (a mesh with ep > 1): each rank holds ``E/ep`` of a
  MoE layer's experts and ``moe_mlp`` sums their f32 partials over the ep
  ranks; attention and the dense leaves are replicated over ep (sharded
  on tp where tp > 1), and a dense model runs no ep collective;
- data parallelism (a mesh with dp > 1): every function here is one
  rank's view — it takes the rank's cache block (the rows of its own
  slots, ``parallel/sharding.kv_cache_pspecs``) and rows of that block;
  ``parallel/data_parallel`` routes a wave's rows to their owners and
  gathers what they sample;
- training (``loss_fn``, the reference's masked mean NLL, with
  ``parallel/train`` and ``parallel/pipeline``): the prefill path is
  differentiable — kernel 1 through its autograd Function
  (``ops/flash_attention``), every collective through its autograd form
  (``parallel/collectives``: the psums' backward the identity, the
  replicated input of each column-parallel product through
  ``copy_to_group``, whose backward sums over tp).  Without grad every
  collective runs as serving always ran it.  Training runs no sp, as the
  reference's ``loss_fn`` passes no mesh to ``prefill``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.models.moe import init_moe_blocks, moe_mlp
from p2p_llm_tunnel_tpu_torch.models.quant import (
    QTensor,
    QTensor4,
    _quantize_act,
    append_packed_token,
    embed_lookup,
    head_matmul,
    is_quantized,
    kernel_layout,
    mm,
    quantize_sym,
    splice_packed_rows,
    write_packed_chunk,
    write_packed_prefix,
)
from p2p_llm_tunnel_tpu_torch.ops.attention import history_attention
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import (
    dequant_f32,
    flash_decode_attention,
)
from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
from p2p_llm_tunnel_tpu_torch.ops.fused_decode import fused_decode_layer, rope_rows
from p2p_llm_tunnel_tpu_torch.ops.fused_spec_decode import (
    burst_rope_rows,
    fused_spec_decode_layer,
)
from p2p_llm_tunnel_tpu_torch.ops.norms import rms_norm
from p2p_llm_tunnel_tpu_torch.ops.prefill_attention import ragged_prefill_attention
from p2p_llm_tunnel_tpu_torch.ops.rope import apply_rope

Params = Dict[str, object]
#: {'k','v': [L, B, S, K, D]} raw or int8, [L, B, S/2, K, D] packed int4;
#: quantized caches add {'k_scale','v_scale': [L, B, S, K]} f32.
KVCache = Dict[str, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card.  With no card and
    no explicit CPU request this raises — the port never carries on
    silently on the CPU, and a ``cuda`` device never fails later at its
    first allocation."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch engine runs on the card; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


def _check_model(cfg: ModelConfig, mesh=None) -> None:
    """tp must divide the query and kv heads, and ep a MoE model's experts
    (a dense model replicates over ep)."""
    if mesh is None:
        return
    if cfg.n_heads % mesh.tp or cfg.n_kv_heads % mesh.tp:
        raise ValueError(f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads do "
                         f"not divide over tp={mesh.tp}")
    if cfg.n_experts and cfg.n_experts % mesh.ep:
        raise ValueError(f"{cfg.n_experts} experts do not divide over "
                         f"ep={mesh.ep}")


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _sp(mesh) -> int:
    return 1 if mesh is None else mesh.sp


def _seq_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the sequence axis (axis 1) under sp; the whole
    ``x`` otherwise.  T must divide over sp (nothing is padded)."""
    sp = _sp(mesh)
    if sp == 1:
        return x
    t = x.shape[1]
    if t % sp:
        raise ValueError(f"sequence parallelism needs the prefill width to "
                         f"divide over sp: T={t}, sp={sp}")
    w = t // sp
    return x[:, mesh.sp_rank * w:(mesh.sp_rank + 1) * w]


def _sp_gather(x: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    """Every sp rank's sequence block of ``x``, in order along ``axis``."""
    if _sp(mesh) == 1:
        return x
    from p2p_llm_tunnel_tpu_torch.parallel.collectives import all_gather

    return all_gather(x, axis, mesh.sp_group)


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the tp ranks (the psum GSPMD inserts after a
    row-parallel product; in place without grad, its backward the
    identity); every rank ends with the same tensor.  A failed collective
    raises."""
    if _tp(mesh) > 1:
        from p2p_llm_tunnel_tpu_torch.parallel.collectives import all_reduce_sum

        return all_reduce_sum(x, mesh.tp_group)
    return x


def _tp_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of a column-parallel product: ``x`` itself,
    whose gradient autograd sums over the tp ranks (each rank's is the
    share of its own columns)."""
    if _tp(mesh) > 1:
        from p2p_llm_tunnel_tpu_torch.parallel.collectives import copy_to_group

        return copy_to_group(x, mesh.tp_group)
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(
    cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None,
    mesh=None,
) -> Params:
    """Random init: truncated normal in [-2, 2] times fan_in**-0.5, the
    reference's shapes and scaling, drawn from a ``torch.Generator`` seeded
    with ``seed`` on the target device (its numbers differ from
    ``jax.random``'s; tests bridge JAX weights with params_from_numpy).
    MoE configs draw the router and expert leaves (``models/moe``) in
    place of the dense MLP's.  On the ``meta`` device it allocates nothing:
    the tree's shapes and dtypes, which ``load_checkpoint`` checks a file
    against.

    With a ``mesh`` (``parallel/mesh``) the tree is this rank's shard
    (``parallel/sharding.param_pspecs``), bitwise the slice
    ``shard_params`` cuts from the whole tree: every piece of the whole
    tree is drawn in the same order, and only this rank's part of each is
    kept — a model too large for one card never exists whole on one."""
    _check_model(cfg, mesh)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    l, dm, h, kh, hd, f, v = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.ffn_dim, cfg.vocab_size,
    )
    specs: Dict[str, tuple] = {}
    if mesh is not None:
        from p2p_llm_tunnel_tpu_torch.parallel.sharding import param_pspecs

        tree = param_pspecs(cfg)
        specs = {**tree["blocks"], "embed": tree["embed"],
                 "lm_head": tree.get("lm_head")}

    # Truncated normal on [-2, 2] by inverse CDF: u ~ U(Phi(-2), Phi(2)),
    # x = sqrt(2) * erfinv(2u - 1).
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo

    def block(axis_name, n):
        """This rank's ``[start, stop)`` of an axis of size ``n``."""
        parts = 1 if axis_name is None else mesh.shape[axis_name]
        if n % parts:
            raise ValueError(f"axis of size {n} does not divide over "
                             f"{axis_name}={parts}")
        w = n // parts
        c = 0 if parts == 1 else mesh.coord(axis_name)
        return c * w, (c + 1) * w

    def dense(shape, fan_in, name):
        spec = specs.get(name) or (None,) * len(shape)
        ranges = [block(a, n) for a, n in zip(spec, shape)]
        out = torch.empty([b - a for a, b in ranges], dtype=dtype, device=dev)
        if gen is None:  # the meta device: shapes and dtypes only
            return out
        # One layer at a time: the fp32 draw of a whole [L, ...] stack would
        # double the 8B model's peak memory (MoE experts: one expert).
        lead = len(shape) - 2 if len(shape) >= 3 else 0
        tail = tuple(slice(a, b) for a, b in ranges[lead:])
        for idx in np.ndindex(*shape[:lead]):
            tmp = torch.empty(shape[lead:], dtype=torch.float32, device=dev)
            tmp.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
            if all(a <= i < b for i, (a, b) in zip(idx, ranges)):
                tmp.erfinv_().mul_(math.sqrt(2.0) * fan_in**-0.5)
                out[tuple(i - a for i, (a, _) in zip(idx, ranges))].copy_(
                    tmp[tail])
        return out

    def norm(shape):
        fill = torch.zeros if cfg.post_norms else torch.ones
        return fill(shape, dtype=dtype, device=dev)

    blocks = {
        "attn_norm": norm((l, dm)),
        "mlp_norm": norm((l, dm)),
        "wq": dense((l, dm, h * hd), dm, "wq"),
        "wk": dense((l, dm, kh * hd), dm, "wk"),
        "wv": dense((l, dm, kh * hd), dm, "wv"),
        "wo": dense((l, h * hd, dm), h * hd, "wo"),
    }
    if cfg.n_experts:
        blocks.update(init_moe_blocks(cfg, dense))
    else:
        blocks.update({
            "w_gate": dense((l, dm, f), dm, "w_gate"),
            "w_up": dense((l, dm, f), dm, "w_up"),
            "w_down": dense((l, f, dm), f, "w_down"),
        })
    if cfg.post_norms:
        blocks["post_attn_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
        blocks["post_mlp_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
    if cfg.attn_bias:
        blocks["bq"] = dense((l, h * hd), dm, "bq")
        blocks["bk"] = dense((l, kh * hd), dm, "bk")
        blocks["bv"] = dense((l, kh * hd), dm, "bv")
    params: Params = {
        "embed": dense((v, dm), dm, "embed"),
        "blocks": blocks,
        "final_norm": norm((dm,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((dm, v), dm, "lm_head")
    return params


def params_from_numpy(tree, device, dtype=torch.bfloat16) -> Params:
    """The JAX package's params pytree, with numpy leaves (same nesting and
    ``[L, ...]`` stacking), as this package's params — so both packages run
    on identical weights.  Imports no JAX: callers hand over numpy arrays
    (``jax.tree.map(np.asarray, params)``).  Float leaves of any width are
    widened to fp32 first (exact for bf16), then cast to ``dtype``.

    Quantized leaves (the reference's ``QTensor``/``QTensor4`` holding
    numpy arrays) are recognised by their attributes — ``q`` and ``scale``,
    plus ``in_dim``, ``group_size`` and ``axis`` for int4 — and become this
    package's leaves with the int8 bytes and f32 scales unchanged, laid
    out as kernel 7 reads them (``quant.kernel_layout``: rows padded to
    whole 16-byte pieces where they are not, views at the same shape)."""
    dev = torch.device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        q = torch.from_numpy(np.array(tree.q, np.int8)).to(dev)
        scale = torch.from_numpy(np.array(tree.scale, np.float32)).to(dev)
        if hasattr(tree, "group_size"):
            return kernel_layout(QTensor4(q, scale, int(tree.in_dim),
                                          int(tree.group_size), int(tree.axis)))
        return kernel_layout(QTensor(q, scale))
    if not isinstance(tree, np.ndarray):
        raise TypeError(f"params leaf of type {type(tree).__name__}")
    arr = np.ascontiguousarray(tree.astype(np.float32))
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def init_kv_cache(
    cfg: ModelConfig, num_slots: int, max_seq: int, dtype=torch.bfloat16,
    quant=False, device=None,
) -> KVCache:
    """Slot cache; ``quant`` selects the storage precision, as in the
    reference: none -> ``{'k','v': [L, num_slots, max_seq, K, D]}`` in
    ``dtype``; ``True``/``"int8"`` -> int8 values plus f32 ``k_scale`` /
    ``v_scale`` ``[L, num_slots, max_seq, K]``; ``"int4"`` -> two adjacent
    tokens per int8 byte along the sequence axis, ``[L, num_slots,
    max_seq/2, K, D]``, with the same full-resolution scales (``max_seq``
    must be even)."""
    modes = {False: None, True: "int8", None: None, "none": None, "": None,
             "int8": "int8", "int4": "int4"}
    if quant not in modes:
        raise ValueError(
            f"unknown KV quant mode {quant!r}; expected one of "
            "False/True/None/'none'/'int8'/'int4'"
        )
    mode = modes[quant]
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_slots, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if mode is None:
        return {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
    if mode == "int4":
        if max_seq % 2:
            raise ValueError(f"int4 KV cache needs an even max_seq, got {max_seq}")
        shape_v = shape[:2] + (max_seq // 2,) + shape[3:]
    else:
        shape_v = shape
    return {
        "k": torch.zeros(shape_v, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape_v, dtype=torch.int8, device=dev),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    }


def kv_cache_is_quantized(kv_cache: KVCache) -> bool:
    return "k_scale" in kv_cache


def kv_cache_quant_mode(kv_cache: KVCache) -> Optional[str]:
    """None | "int8" | "int4" — int4 is recognized by its byte-packed
    sequence axis (half the scale plane's)."""
    if "k_scale" not in kv_cache:
        return None
    if kv_cache["k"].shape[2] * 2 == kv_cache["k_scale"].shape[2]:
        return "int4"
    return "int8"


def _seq_len(kv_cache: KVCache) -> int:
    """Token positions per slot row (the int4 value planes hold half as
    many bytes)."""
    return kv_cache["k"].shape[2] * (2 if kv_cache_quant_mode(kv_cache) == "int4" else 1)


def _quant_kv(x: torch.Tensor):
    """Symmetric int8 over the trailing head_dim axis -> (q, scale): the
    activation-quant formula (models/quant._quantize_act)."""
    q, scale = _quantize_act(x)
    return q, scale[..., 0]


def _quant_kv4(x: torch.Tensor):
    """Symmetric int4 over the trailing head_dim axis -> (values in [-7, 7]
    as int8 — callers pack — and the per-(token, head) scale).  The formula
    the fused decode and ragged prefill kernels apply to their new rows."""
    q, scale = quantize_sym(x, 7.0)
    return q.to(torch.int8), scale[..., 0]


def _write_rows(plane: torch.Tensor, rows, pos, inside, new) -> None:
    """``plane[rows, pos] = new`` IN PLACE where ``inside``, else the old
    value written back (the caller clamps ``pos`` into the plane)."""
    old = plane[rows, pos]
    mask = inside.reshape(inside.shape + (1,) * (new.dim() - inside.dim()))
    plane[rows, pos] = torch.where(mask, new.to(plane.dtype), old)


# ---------------------------------------------------------------------------
# shared block pieces
# ---------------------------------------------------------------------------

def _layer(blocks: Params, idx: int) -> Dict[str, torch.Tensor]:
    """Views of layer ``idx`` of the stacked block weights."""
    return {name: arr[idx] for name, arr in blocks.items()}


def _norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.post_norms)


def _act(cfg: ModelConfig, x):
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _mlp(cfg: ModelConfig, blk, h, mesh=None):
    if cfg.n_experts:
        return moe_mlp(cfg, blk, h, lambda x: _act(cfg, x), mesh)
    aq = cfg.act_quant
    gate = _act(cfg, mm(h, blk["w_gate"], aq)) * mm(h, blk["w_up"], aq)
    return mm(gate, blk["w_down"], aq)


def _qkv_proj(cfg: ModelConfig, blk, h):
    """QKV projections + bias + head split, no rope."""
    b, t, _ = h.shape
    aq = cfg.act_quant
    q = mm(h, blk["wq"], aq)
    k = mm(h, blk["wk"], aq)
    v = mm(h, blk["wv"], aq)
    if cfg.attn_bias:  # qwen2: additive bias on the Q/K/V projections
        q = q + blk["bq"].to(q.dtype)
        k = k + blk["bk"].to(k.dtype)
        v = v + blk["bv"].to(v.dtype)
    # Heads from the widths: under tp a rank holds H/tp and K/tp of them.
    q = q.reshape(b, t, -1, cfg.head_dim)
    k = k.reshape(b, t, -1, cfg.head_dim)
    v = v.reshape(b, t, -1, cfg.head_dim)
    return q, k, v


def _qkv(cfg: ModelConfig, blk, h, positions):
    q, k, v = _qkv_proj(cfg, blk, h)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _layer_window(cfg: ModelConfig, layer_idx: int, seq_len: int) -> Optional[int]:
    """Per-layer sliding window (None when the config never windows):
    gemma-2 alternates local/global layers, mistral windows every layer."""
    if cfg.sliding_window is None:
        return None
    if cfg.window_pattern == "all":
        return cfg.sliding_window
    return cfg.sliding_window if layer_idx % 2 == 0 else seq_len + 1


def _block_tail(cfg: ModelConfig, blk, x, attn, mesh=None):
    """Output projection, residuals and the MLP half of one block.  Under
    tp the row-parallel ``wo`` and ``w_down`` products are partial sums
    over this rank's heads / FFN slice, summed across ranks before the
    residual; MoE experts are replicated over tp and summed over ep inside
    ``moe_mlp``."""
    b, t = x.shape[:2]
    attn = _psum(mm(attn.reshape(b, t, -1), blk["wo"], cfg.act_quant), mesh)
    if cfg.post_norms:
        attn = _norm(cfg, attn, blk["post_attn_norm"])
    x = x + attn
    h = _norm(cfg, x, blk["mlp_norm"])
    mlp = _mlp(cfg, blk, h if cfg.n_experts else _tp_copy(h, mesh), mesh)
    if not cfg.n_experts:
        mlp = _psum(mlp, mesh)
    if cfg.post_norms:
        mlp = _norm(cfg, mlp, blk["post_mlp_norm"])
    return x + mlp


def embed_tokens(cfg: ModelConfig, params, tokens, mesh=None):
    """The token embeddings ``[..., Dm]`` (scaled where the model scales
    them); under tp the vocab-parallel lookup, summed over the group."""
    embed = params["embed"]
    # A quantized table dequantizes into bf16 activations; every product
    # downstream follows x's dtype (quant.mm).
    dtype = torch.bfloat16 if is_quantized(embed) else embed.dtype
    if _tp(mesh) > 1:
        # Vocab-parallel lookup: this rank holds rows [lo, lo + rows); ids
        # outside gather row 0 and are zeroed, and the sum over ranks
        # leaves every id's row (x + 0 is exact at any width).
        rows = embed.shape[0]
        local = tokens.to(torch.long) - mesh.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = embed_lookup(embed, torch.where(inside, local, 0), dtype)
        x = _psum(torch.where(inside[..., None], x, torch.zeros_like(x)), mesh)
    else:
        x = embed_lookup(embed, tokens, dtype)
    if cfg.embed_scale:
        x = (x.to(torch.float32) * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _logits(cfg: ModelConfig, params, x, mesh=None):
    """f32 logits ``[..., V]``.  Under tp the head is vocab-sharded: each
    rank computes its ``V/tp`` columns (softcapped, elementwise), and the
    columns of every tp rank are gathered in rank order
    (``parallel/collectives.all_gather``, exact)."""
    x = _tp_copy(x, mesh)
    if cfg.tie_embeddings:
        logits = head_matmul(x, params["embed"], cfg.act_quant).to(torch.float32)
    else:
        logits = mm(x, params["lm_head"], cfg.act_quant).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if _tp(mesh) > 1:
        from p2p_llm_tunnel_tpu_torch.parallel.collectives import all_gather

        logits = all_gather(logits, -1, mesh.tp_group)
    return logits


def final_logits(cfg: ModelConfig, params, x, mesh=None):
    """The final norm, then the head: f32 logits ``[..., V]`` of the last
    block's output ``x``."""
    return _logits(cfg, params, _norm(cfg, x, params["final_norm"]), mesh)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _prefill_attention(cfg: ModelConfig, mesh):
    """The prefill attention of this (config, mesh), as the reference's
    ``_prefill_attention_fn``: ``fn(q, k, v, valid, window)`` on this
    rank's blocks.  sp > 1 picks sequence parallelism by ``cfg.sp_mode``:
    "ulysses" (kernel 1 over the whole sequence at H/sp heads; pad masks
    and windows work) or "ring" (no pad mask needed: right-padding sits
    after every real query, so causality masks it; refuses sliding
    windows).  Otherwise kernel 1 (per head shard under tp)."""
    sp = _sp(mesh)
    if sp > 1 and cfg.sp_mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_mode {cfg.sp_mode!r}")
    if sp > 1 and cfg.sp_mode == "ulysses":
        from p2p_llm_tunnel_tpu_torch.ops.ulysses_attention import (
            check_heads,
            ulysses_attention,
        )

        if cfg.n_heads % sp or cfg.n_kv_heads % sp:
            raise ValueError(
                f"ulysses sp={sp} needs H ({cfg.n_heads}) and K "
                f"({cfg.n_kv_heads}) divisible by sp; use sp_mode='ring'"
            )
        check_heads(cfg.n_heads, cfg.n_kv_heads, sp, mesh.tp)
        return lambda q, k, v, valid, window: ulysses_attention(
            q, k, v, valid, group=mesh.sp_group,
            scale=cfg.query_scale, softcap=cfg.attn_softcap, window=window)
    if sp > 1:
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "ring attention does not support sliding windows; "
                "use sp_mode='ulysses' or an sp=1 mesh for windowed models"
            )
        from p2p_llm_tunnel_tpu_torch.ops.ring_attention import ring_attention

        return lambda q, k, v, valid, window: ring_attention(
            q, k, v, group=mesh.sp_group, scale=cfg.query_scale,
            softcap=cfg.attn_softcap)
    return lambda q, k, v, valid, window: flash_causal_attention(
        q, k, v, valid, scale=cfg.query_scale, softcap=cfg.attn_softcap,
        window=window)


def apply_blocks(
    cfg: ModelConfig,
    blocks: Params,
    x: torch.Tensor,  # [B, T/sp, Dm] embedded activations (this rank's block)
    valid: torch.Tensor,  # [B, T] bool, the whole sequence
    store_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
    mesh=None,
    layer_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run a stacked block chunk (the whole stack, or a pipeline stage's
    ``[L/pp, ...]`` whose first layer is global layer ``layer_offset``,
    which places gemma's alternating windows) over the prompt batch.
    Each layer's (k, v) go to
    ``store_kv(layer, k, v)`` when given (prefill_into_cache writes them
    straight into the cache), else they are stacked and returned as
    ``[L, B, T/sp, K, D]``.  Under tp kernel 1 runs on this rank's head
    shard (H/tp query and K/tp kv heads: GQA grouping is shard-local), as
    the reference's ``flash_tp`` runs the Pallas kernel per head shard.
    Under sp ``x``, the returned activations and the K/V handed on are this
    rank's sequence block (``_seq_block``), at global positions."""
    b, tl, _ = x.shape
    t = valid.shape[1]
    start = mesh.sp_rank * tl if _sp(mesh) > 1 else 0
    positions = (start + torch.arange(tl, device=x.device)).expand(b, tl)
    attention = _prefill_attention(cfg, mesh)
    ks, vs = [], []
    for idx in range(blocks["attn_norm"].shape[0]):
        blk = _layer(blocks, idx)
        h = _tp_copy(_norm(cfg, x, blk["attn_norm"]), mesh)
        q, k, v = _qkv(cfg, blk, h, positions)
        attn = attention(q, k, v, valid, _layer_window(cfg, layer_offset + idx, t))
        x = _block_tail(cfg, blk, x, attn, mesh)
        if store_kv is not None:
            store_kv(idx, k, v)
        else:
            ks.append(k)
            vs.append(v)
    if store_kv is not None:
        return x, None, None
    return x, torch.stack(ks), torch.stack(vs)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] right-padded
    valid: torch.Tensor,  # [B, T] bool
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (logits [B,T,V] fp32, k, v [L,B,T,K,D]);
    under sp every rank returns the whole sequence's."""
    _check_model(cfg, mesh)
    x = embed_tokens(cfg, params, _seq_block(tokens, mesh), mesh)
    x, ks, vs = apply_blocks(cfg, params["blocks"], x, valid, mesh=mesh)
    return (final_logits(cfg, params, _sp_gather(x, mesh), mesh),
            _sp_gather(ks, mesh, 2), _sp_gather(vs, mesh, 2))


def encode_pooled(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] right-padded
    valid: torch.Tensor,  # [B, T] bool
    mesh=None,
) -> torch.Tensor:
    """Mean-pooled, L2-normalized final hidden states — the embeddings
    surface (/v1/embeddings, Ollama /api/embed), as the reference's
    ``encode_pooled``: the blocks through kernel 1 (no K/V kept), the
    final norm, a masked mean over the real tokens in f32 (count floored
    at 1), L2-normalized with a 1e-9 floor.  Returns ``[B, Dm]`` float32.
    A row with no real token (a pad row) pools to zero; its attention
    differs between kernel 1 (zero) and its plain version (the mean of V),
    and the engine drops such rows."""
    _check_model(cfg, mesh)
    x = embed_tokens(cfg, params, _seq_block(tokens, mesh), mesh)
    x, _, _ = apply_blocks(cfg, params["blocks"], x, valid,
                           store_kv=lambda idx, k, v: None, mesh=mesh)
    x = _norm(cfg, _sp_gather(x, mesh), params["final_norm"]).to(torch.float32)
    m = valid[..., None].to(torch.float32)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp(min=1e-9)


def prefill_into_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [Bp, T]
    lengths: torch.Tensor,  # [Bp]
    kv_cache: KVCache,
    slots: torch.Tensor,  # [Bp] cache slot per prompt
    mesh=None,
    return_prompt_logprobs: bool = False,
):
    """Prefill prompts and write their KV into cache slots, IN PLACE.

    Returns last-real-token logits [Bp, V] and the (same, updated) cache.
    Positions past a prompt's length hold junk KV that decode overwrites
    before it becomes attendable; pad rows carry the scratch slot, so
    several rows may write it (which one wins does not matter).  Only the
    last real token's hidden state goes through the LM head — the
    reference computes the full [Bp, T, V] logits and gathers (4 GB of fp32
    at 8 rows x 1024 x 128k vocab); per row the arithmetic is the same.

    With ``return_prompt_logprobs`` additionally returns [Bp, T] log-probs
    of each prompt token given its prefix (entry 0 is 0.0), the echo path.

    A quantized cache stores each layer's K/V quantized after that layer's
    attention (which reads the unquantized prompt K/V, as the reference's
    does); int4 pads an odd width with one zero position so the packed
    write covers whole bytes — a position past the prompt that decode
    overwrites before it is attendable.

    Under sp every rank takes the whole batch, prefills its sequence block,
    and gathers each layer's K/V to the whole sequence before writing its
    own (replicated) cache.
    """
    _check_model(cfg, mesh)
    b, t = tokens.shape
    mode = kv_cache_quant_mode(kv_cache)
    valid = torch.arange(t, device=tokens.device)[None, :] < lengths[:, None]
    t_w = min(t, _seq_len(kv_cache))
    slot_idx = slots.to(torch.long)

    def store(idx, k, v):
        k, v = _sp_gather(k, mesh), _sp_gather(v, mesh)
        for name, new in (("k", k[:, :t_w]), ("v", v[:, :t_w])):
            if mode is None:
                # Cast as the reference's scatter does: a quantized table
                # gathers bf16 activations, whatever the cache's dtype.
                kv_cache[name][idx, slot_idx, :t_w] = new.to(kv_cache[name].dtype)
                continue
            vals, sc = (_quant_kv4 if mode == "int4" else _quant_kv)(new)
            kv_cache[name + "_scale"][idx, slot_idx, :t_w] = sc
            if mode == "int8":
                kv_cache[name][idx, slot_idx, :t_w] = vals
                continue
            if t_w % 2:
                vals = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
            write_packed_prefix(kv_cache[name][idx:idx + 1], slot_idx, vals[None])

    x = embed_tokens(cfg, params, _seq_block(tokens, mesh), mesh)
    x, _, _ = apply_blocks(cfg, params["blocks"], x, valid, store_kv=store,
                           mesh=mesh)
    x = _sp_gather(x, mesh)
    rows = torch.arange(b, device=tokens.device)
    last_idx = (lengths - 1).to(torch.long)
    if not return_prompt_logprobs:
        h_last = _norm(cfg, x[rows, last_idx][:, None], params["final_norm"])
        return _logits(cfg, params, h_last, mesh)[:, 0], kv_cache
    logits = _logits(cfg, params, _norm(cfg, x, params["final_norm"]), mesh)
    last = logits[rows, last_idx]
    lsm = torch.log_softmax(logits[:, :-1], dim=-1)
    scored = torch.gather(lsm, -1, tokens[:, 1:, None].to(torch.long))[..., 0]
    prompt_lps = torch.cat(
        [torch.zeros((b, 1), dtype=torch.float32, device=tokens.device),
         scored.to(torch.float32)], dim=1,
    )
    return last, kv_cache, prompt_lps


def chunk_prefill_into_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [Bp, T] right-padded TAIL tokens
    lengths: torch.Tensor,  # [Bp] real tail lengths
    starts: torch.Tensor,  # [Bp] history length per row (tail begins here)
    kv_cache: KVCache,
    slots: torch.Tensor,  # [Bp] cache slot per prompt
    kv_view: Optional[int] = None,  # attend only to cache[:kv_view]
    return_all_logits: bool = False,  # [Bp, T, V] instead of the last
    unaligned_int4: bool = False,  # arbitrary-parity int4 starts and widths
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill only the TAIL of each prompt against reused history KV (the
    prefix-cache and chunked-prefill path, and the speculative verify
    fallback).

    Positions ``[0, starts)`` of each row's slot already hold history KV;
    this computes the ``lengths`` tail tokens at global positions
    ``starts + i`` (RoPE included), writes their K/V into the cache IN
    PLACE, and attends each tail query to history + the causal part of the
    tail through ``ops/attention.history_attention`` over
    ``cache[:kv_view]`` — einsum attention, as in the reference, on either
    device.  With ``starts == 0`` it computes what ``prefill_into_cache``
    does.

    Tail positions past the cache (a padded tail ending beyond ``max_seq``)
    are pad tokens: XLA's scatter drops their writes, torch indexing would
    fault on CUDA, so they rewrite the row's own old value at ``pos - T``
    instead — a history position no real write of this call touches, and
    distinct for each such pad.  Returns last-real-tail-token logits
    ``[Bp, V]`` (every position's ``[Bp, T, V]`` with
    ``return_all_logits``, as a verify burst needs) and the (same, updated)
    cache.

    Quantized caches: the tail is quantized and written (int4 as whole
    bytes — every start and the padded width ``T`` must be even, which the
    engine's page alignment guarantees, unless ``unaligned_int4`` routes the
    packed writes through ``quant.splice_packed_rows``: spec verify starts
    are arbitrary token positions), then the view is read back dequantized
    through f32 into the activation dtype before attention, exactly as the
    reference reads it."""
    _check_model(cfg, mesh)
    b, t = tokens.shape
    mode = kv_cache_quant_mode(kv_cache)
    if mode == "int4" and t % 2 and not unaligned_int4:
        raise ValueError(
            f"packed int4 chunk prefill needs an even (page-aligned) tail "
            f"width, got {t}; the engine pads tails to even buckets"
        )
    s = _seq_len(kv_cache)
    if kv_view is None or kv_view > s:
        kv_view = s
    x = embed_tokens(cfg, params, tokens, mesh)
    pos = starts.to(torch.long)[:, None] + torch.arange(t, device=tokens.device)[None, :]
    in_cache = pos < s
    write_pos = torch.where(pos < s, pos, pos - t)
    slot_idx = slots.to(torch.long)
    rows = slot_idx[:, None]  # [Bp,1] broadcasts against [Bp,T]
    view_rows = kv_view // 2 if mode == "int4" else kv_view
    if mode == "int4":
        bpos = starts.to(torch.long)[:, None] // 2 + torch.arange(
            t // 2, device=tokens.device)[None, :]
    for idx in range(cfg.n_layers):
        blk = _layer(params["blocks"], idx)
        q, k, v = _qkv(cfg, blk, _norm(cfg, x, blk["attn_norm"]), pos)
        for name, new in (("k", k), ("v", v)):
            if mode is None:
                _write_rows(kv_cache[name][idx], rows, write_pos, in_cache, new)
                continue
            vals, sc = (_quant_kv4 if mode == "int4" else _quant_kv)(new)
            _write_rows(kv_cache[name + "_scale"][idx], rows, write_pos,
                        in_cache, sc)
            if mode == "int4" and unaligned_int4:
                splice_packed_rows(kv_cache[name], idx, slot_idx, starts, vals)
            elif mode == "int4":
                write_packed_chunk(kv_cache[name], idx, rows, bpos, vals)
            else:
                _write_rows(kv_cache[name][idx], rows, write_pos, in_cache, vals)
        k_all = kv_cache["k"][idx, :, :view_rows][slot_idx]
        v_all = kv_cache["v"][idx, :, :view_rows][slot_idx]
        if mode is not None:
            # Dequantized through f32 into the activation dtype, as the
            # reference's chunk path reads a quantized view.
            k_all = dequant_f32(k_all, kv_cache["k_scale"][idx, :, :kv_view][slot_idx],
                                mode).to(x.dtype)
            v_all = dequant_f32(v_all, kv_cache["v_scale"][idx, :, :kv_view][slot_idx],
                                mode).to(x.dtype)
        attn = history_attention(
            q, k_all, v_all, starts,
            scale=cfg.query_scale, softcap=cfg.attn_softcap,
            window=_layer_window(cfg, idx, kv_view),
        )
        x = _block_tail(cfg, blk, x, attn, mesh)
    if return_all_logits:
        return (_logits(cfg, params, _norm(cfg, x, params["final_norm"]), mesh),
                kv_cache)
    last = x[torch.arange(b, device=tokens.device), (lengths - 1).to(torch.long)]
    h_last = _norm(cfg, last[:, None], params["final_norm"])
    return _logits(cfg, params, h_last, mesh)[:, 0], kv_cache


def spec_verify_into_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] carry token + K proposals per slot
    positions: torch.Tensor,  # [B] int32: global position of tokens[:, 0]
    kv_cache: KVCache,
    kv_view: Optional[int] = None,  # attend only to cache[:kv_view]
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Speculative draft-verify burst: T = 1 + K positions per slot in ONE
    forward pass; returns (logits ``[B, T, V]``, the same cache updated IN
    PLACE).

    With ``cfg.fused_decode_layer`` each layer's attention sub-block is ONE
    ``fused_spec_decode_layer`` call on the pre-rope projections (kernel 5:
    rope, quantization, the T appends and causal attention over the cache
    with the burst's own rows substituted), one rope table per burst, and
    the tail shared with ``decode_step``; its token streams are those of T
    sequential fused decode steps.  Otherwise the burst runs the chunk path
    (``chunk_prefill_into_cache`` with every position's logits) and writes
    int4 caches through ``quant.splice_packed_rows``, spec starts being
    arbitrary token positions.  The TPU's tiling gates do not apply on the
    card: the engine fences the fused layer where the head geometry has no
    kernel-5 instance.

    Rejected-tail KV needs no rollback: it lies past every accepted
    position and every mask is strictly below the query's position, so the
    row's next burst or step rewrites it before anything attends it.
    Inactive slots park at ``positions >= kv_view`` and write nothing."""
    _check_model(cfg, mesh)
    b, t = tokens.shape
    mode = kv_cache_quant_mode(kv_cache)
    s = _seq_len(kv_cache)
    if kv_view is None or kv_view > s:
        kv_view = s
    if not cfg.fused_decode_layer or _tp(mesh) > 1:
        # The reference's kernel_ok needs tp == 1: under tp the verify
        # burst runs the chunk path, as there.
        lengths = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
        return chunk_prefill_into_cache(
            cfg, params, tokens, lengths, positions, kv_cache,
            torch.arange(b, device=tokens.device), kv_view=kv_view,
            return_all_logits=True, unaligned_int4=True, mesh=mesh,
        )
    x = embed_tokens(cfg, params, tokens)  # [B, T, Dm]
    rope = burst_rope_rows(positions, t, cfg.head_dim, cfg.rope_theta)
    for idx in range(cfg.n_layers):
        blk = _layer(params["blocks"], idx)
        q, k, v = _qkv_proj(cfg, blk, _norm(cfg, x, blk["attn_norm"]))
        attn = fused_spec_decode_layer(
            q, k, v, kv_cache["k"], kv_cache["v"], kv_cache.get("k_scale"),
            kv_cache.get("v_scale"), positions, idx, kv_view=kv_view,
            rope_theta=cfg.rope_theta, kv_quant=mode, scale=cfg.query_scale,
            softcap=cfg.attn_softcap, window=_layer_window(cfg, idx, s),
            rope=rope,
        )
        x = _block_tail(cfg, blk, x, attn, mesh)
    x = _norm(cfg, x, params["final_norm"])
    return _logits(cfg, params, x), kv_cache


def ragged_prefill_into_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [TOT] flat-packed tail tokens (pads = 0)
    slot_of, start_of, qoff_of, base_of,  # [NQB] int32 (plan_ragged_group)
    sample_idx: torch.Tensor,  # [R] flat index of each row's last real token
    kv_cache: KVCache,
    block_q: int,
    return_all_logits: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Ragged GROUPED prefill: one ``ragged_prefill_attention`` launch per
    layer for a whole group of variable-length tails (the ragged twin of
    :func:`chunk_prefill_into_cache`).  Per layer the projections run over
    the flat ``[TOT]`` axis; the attention wrapper ropes q/K at global
    positions, appends K/V into the cache IN PLACE and attends history +
    tail — the Hopper kernel on CUDA tensors, its plain version on CPU
    tensors.  The descriptors are int32 tensors on the activations'
    device; the planner has checked them against the alignment contract.

    Returns the logits of each row's ``sample_idx`` token ``[R, V]`` (or
    ``[TOT, V]`` with ``return_all_logits``) and the updated cache.  A
    quantized cache's scale planes ride along: the kernel quantizes each
    appended row and writes its scale beside it.  It does not run under tp
    (the engine fences ``ragged_prefill`` there, as the reference); a
    ``mesh`` carries ep's expert sum."""
    if mesh is not None and mesh.tp > 1:
        raise ValueError("ragged_prefill_into_cache does not run under tp")
    _check_model(cfg, mesh)
    descs = (slot_of, start_of, qoff_of, base_of)
    s = _seq_len(kv_cache)
    x = embed_tokens(cfg, params, tokens[None])  # [1, TOT, Dm]
    for idx in range(cfg.n_layers):
        blk = _layer(params["blocks"], idx)
        q, k, v = _qkv_proj(cfg, blk, _norm(cfg, x, blk["attn_norm"]))
        attn = ragged_prefill_attention(
            q[0], k[0], v[0], kv_cache["k"], kv_cache["v"], *descs, idx,
            k_scale=kv_cache.get("k_scale"), v_scale=kv_cache.get("v_scale"),
            kv_quant=kv_cache_quant_mode(kv_cache),
            block_q=block_q, rope_theta=cfg.rope_theta,
            scale=cfg.query_scale, softcap=cfg.attn_softcap,
            window=_layer_window(cfg, idx, s),
        )
        x = _block_tail(cfg, blk, x, attn[None], mesh)
    if return_all_logits:
        return _logits(cfg, params, _norm(cfg, x, params["final_norm"]))[0], kv_cache
    rows = x[0][sample_idx.to(torch.long)][None]  # [1, R, Dm]
    return _logits(cfg, params, _norm(cfg, rows, params["final_norm"]))[0], kv_cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(
    cfg: ModelConfig,
    params: Params,
    kv_cache: KVCache,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] int32: where this token goes in the cache
    kv_view: Optional[int] = None,  # attend only to cache[:kv_view]
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over every slot. Returns (logits [B,V], cache) with
    the new token's K/V written into the cache IN PLACE.

    Rows whose position is past the cache (parked or finished slots) write
    nothing: XLA's scatter drops out-of-bounds writes and the engine relies
    on that, but a torch index past S faults on CUDA — so such rows write
    their own old row back at a clamped position instead, on the device,
    with no host sync.  ``kv_view`` bounds how much of the cache attention
    reads (the engine's power-of-two buckets); writes target the full
    cache.

    With ``cfg.fused_decode_layer`` each layer's attention sub-block —
    rope of q and the new k, the new row's quantization, its in-place
    append and the attention — is ONE ``fused_decode_layer`` call on the
    pre-rope projections (kernel 4); otherwise the new row is roped,
    quantized and written here and ``flash_decode_attention`` (kernel 2,
    in the cache's form) reads the ``[:, :kv_view]`` view in place."""
    _check_model(cfg, mesh)
    b = tokens.shape[0]
    mode = kv_cache_quant_mode(kv_cache)
    s = _seq_len(kv_cache)
    if kv_view is None or kv_view > s:
        kv_view = s
    x = embed_tokens(cfg, params, tokens[:, None], mesh)  # [B,1,Dm]
    # The reference's kernel_ok needs tp == 1 for the fused layer: under tp
    # decode runs unfused (kernel 2 per head shard).
    if cfg.fused_decode_layer and _tp(mesh) == 1:
        rope = rope_rows(positions, cfg.head_dim, cfg.rope_theta)  # one per step
        for idx in range(cfg.n_layers):
            blk = _layer(params["blocks"], idx)
            q, k, v = _qkv_proj(cfg, blk, _norm(cfg, x, blk["attn_norm"]))
            attn = fused_decode_layer(
                q[:, 0], k[:, 0], v[:, 0], kv_cache["k"], kv_cache["v"],
                kv_cache.get("k_scale"), kv_cache.get("v_scale"), positions,
                idx, kv_view=kv_view, rope_theta=cfg.rope_theta,
                kv_quant=mode, scale=cfg.query_scale,
                softcap=cfg.attn_softcap, window=_layer_window(cfg, idx, s),
                rope=rope,
            )
            x = _block_tail(cfg, blk, x, attn[:, None], mesh)
        x = _norm(cfg, x, params["final_norm"])
        return _logits(cfg, params, x)[:, 0], kv_cache
    pos2d = positions[:, None]
    in_cache = positions < s
    write_pos = positions.clamp(max=s - 1).to(torch.long)
    slot_ids = torch.arange(b, device=tokens.device)
    view_rows = kv_view // 2 if mode == "int4" else kv_view
    for idx in range(cfg.n_layers):
        blk = _layer(params["blocks"], idx)
        q, k, v = _qkv(cfg, blk, _norm(cfg, x, blk["attn_norm"]), pos2d)
        for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
            if mode is None:
                _write_rows(kv_cache[name][idx], slot_ids, write_pos, in_cache, new)
                continue
            vals, sc = (_quant_kv4 if mode == "int4" else _quant_kv)(new)
            _write_rows(kv_cache[name + "_scale"][idx], slot_ids, write_pos,
                        in_cache, sc)
            if mode == "int4":
                append_packed_token(kv_cache[name], idx, slot_ids, positions, vals)
            else:
                _write_rows(kv_cache[name][idx], slot_ids, write_pos, in_cache, vals)
        scales = {}
        if mode is not None:
            scales = dict(k_scale=kv_cache["k_scale"][idx, :, :kv_view],
                          v_scale=kv_cache["v_scale"][idx, :, :kv_view],
                          kv_quant=mode)
        attn = flash_decode_attention(
            q, kv_cache["k"][idx, :, :view_rows], kv_cache["v"][idx, :, :view_rows],
            positions, scale=cfg.query_scale, softcap=cfg.attn_softcap,
            window=_layer_window(cfg, idx, s), **scales,
        )
        x = _block_tail(cfg, blk, x, attn, mesh)
    x = _norm(cfg, x, params["final_norm"])
    return _logits(cfg, params, x, mesh)[:, 0], kv_cache


# ---------------------------------------------------------------------------
# training objective (parallel/train, parallel/pipeline)
# ---------------------------------------------------------------------------

def check_training_mesh(mesh) -> None:
    """Training runs no sequence parallelism, as the reference's: its
    ``loss_fn`` passes no mesh to ``prefill``, so sp never enters its
    train step (and ring and Ulysses attention have no backward here)."""
    if _sp(mesh) > 1:
        raise ValueError(
            f"training does not run under sp={mesh.sp}: the reference's loss_fn "
            "passes no mesh to prefill, so sequence parallelism never enters "
            "its train step; train on an sp 1 mesh"
        )


def nll_sum(logits: torch.Tensor, targets: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """``sum(nll * valid)`` of fp32 logits ``[B, T, V]`` against ``targets``
    ``[B, T]``: the numerator of ``loss_fn``'s masked mean."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].to(torch.long))[..., 0]
    return (nll * valid.to(nll.dtype)).sum()


def masked_mean(total: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``total / max(sum(valid), 1)``: the reference's masked mean."""
    return total / valid.sum().clamp(min=1)


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T]
    targets: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T] bool
    mesh=None,
) -> torch.Tensor:
    """The masked mean next-token NLL over ``prefill``'s fp32 logits, as
    the reference's ``loss_fn``: ``sum(nll * valid) / max(sum(valid), 1)``.
    Differentiable through kernel 1 (``ops/flash_attention``) and, under a
    tp or ep ``mesh`` (this rank's shard of ``params``), through every
    collective of the forward; the loss is the same on every rank.  An sp
    mesh raises (``check_training_mesh``)."""
    check_training_mesh(mesh)
    logits = prefill(cfg, params, tokens, valid, mesh)[0]
    return masked_mean(nll_sum(logits, targets, valid), valid)
