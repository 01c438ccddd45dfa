"""Decoder-only transformer (llama/gemma families) in plain PyTorch — the
port of p2p_llm_tunnel_tpu/models/transformer.py, subset the non-mux
serving path runs: random init, the raw ``[L, B, S, K, D]`` KV cache,
prefill (whole prompts, batched) and one-token-per-slot decode.

Idiom differences from the JAX reference, all deliberate:

- the layer loop is a Python loop over per-layer views of the stacked
  ``[L, ...]`` weights where JAX uses ``lax.scan``;
- the KV cache is MUTATED IN PLACE (JAX rebuilt it functionally and let
  XLA alias the buffers); every function that writes it says so and still
  returns it, so call sites read like the reference's;
- attention always goes through the two kernel wrappers
  (``ops/flash_attention``, ``ops/decode_attention``): on CUDA tensors they
  launch the Hopper kernels, on CPU tensors they run the plain versions.
  ``ModelConfig.flash``/``flash_decode`` pick between XLA and Pallas on a
  TPU and choose nothing here.

Knobs of the reference this slice does not port raise ``NotPorted`` (a
NotImplementedError) naming their ROADMAP.md port-queue item.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import flash_decode_attention
from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
from p2p_llm_tunnel_tpu_torch.ops.norms import rms_norm
from p2p_llm_tunnel_tpu_torch.ops.rope import apply_rope

Params = Dict[str, object]
KVCache = Dict[str, torch.Tensor]  # {'k','v': [L, B, S, K, D]}


class NotPorted(NotImplementedError):
    """A feature of the JAX package this port does not run yet; the message
    names its ROADMAP.md port-queue item.  The serve layer answers it as a
    typed upstream error."""

    tunnel_code = "upstream"

    def __init__(self, what: str, item: str):
        super().__init__(
            f"{what} is not ported to the PyTorch engine yet "
            f"(ROADMAP.md, port queue: {item})"
        )


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card.  With no card and
    no explicit CPU request this raises — the port never carries on
    silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch engine runs on the card; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return torch.device("cuda")


def _check_model(cfg: ModelConfig, mesh=None) -> None:
    if cfg.n_experts:
        raise NotPorted("mixture-of-experts (n_experts)", "checkpoints and MoE")
    if cfg.fused_decode_layer:
        raise NotPorted("fused_decode_layer", "fused decode layer (kernel 4)")
    if cfg.act_quant:
        raise NotPorted("act_quant (w8a8)", "quantized weights and KV")
    if mesh is not None:
        raise NotPorted("device meshes (tp/sp/ep)", "parallel/")


def _check_cache(kv_cache: KVCache) -> None:
    if "k_scale" in kv_cache:
        raise NotPorted("quantized KV caches", "quantized weights and KV")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(
    cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None
) -> Params:
    """Random init: truncated normal in [-2, 2] times fan_in**-0.5, the
    reference's shapes and scaling, drawn from a ``torch.Generator`` seeded
    with ``seed`` on the target device (its numbers differ from
    ``jax.random``'s; tests bridge JAX weights with params_from_numpy)."""
    _check_model(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    l, dm, h, kh, hd, f, v = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.ffn_dim, cfg.vocab_size,
    )

    # Truncated normal on [-2, 2] by inverse CDF: u ~ U(Phi(-2), Phi(2)),
    # x = sqrt(2) * erfinv(2u - 1).
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        # One layer at a time: the fp32 draw of a whole [L, ...] stack would
        # double the 8B model's peak memory.
        pieces = out.unbind(0) if len(shape) == 3 else (out,)
        for piece in pieces:
            tmp = torch.empty(piece.shape, dtype=torch.float32, device=dev)
            tmp.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
            tmp.erfinv_().mul_(math.sqrt(2.0) * fan_in**-0.5)
            piece.copy_(tmp)
        return out

    def norm(shape):
        fill = torch.zeros if cfg.post_norms else torch.ones
        return fill(shape, dtype=dtype, device=dev)

    blocks = {
        "attn_norm": norm((l, dm)),
        "mlp_norm": norm((l, dm)),
        "wq": dense((l, dm, h * hd), dm),
        "wk": dense((l, dm, kh * hd), dm),
        "wv": dense((l, dm, kh * hd), dm),
        "wo": dense((l, h * hd, dm), h * hd),
        "w_gate": dense((l, dm, f), dm),
        "w_up": dense((l, dm, f), dm),
        "w_down": dense((l, f, dm), f),
    }
    if cfg.post_norms:
        blocks["post_attn_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
        blocks["post_mlp_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
    if cfg.attn_bias:
        blocks["bq"] = dense((l, h * hd), dm)
        blocks["bk"] = dense((l, kh * hd), dm)
        blocks["bv"] = dense((l, kh * hd), dm)
    params: Params = {
        "embed": dense((v, dm), dm),
        "blocks": blocks,
        "final_norm": norm((dm,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((dm, v), dm)
    return params


def params_from_numpy(tree, device, dtype=torch.bfloat16) -> Params:
    """The JAX package's params pytree, with numpy leaves (same nesting and
    ``[L, ...]`` stacking), as this package's params — so both packages run
    on identical weights.  Imports no JAX: callers hand over numpy arrays
    (``jax.tree.map(np.asarray, params)``).  Float leaves of any width are
    widened to fp32 first (exact for bf16), then cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        raise NotPorted(
            f"params leaf of type {type(tree).__name__} (quantized weights?)",
            "quantized weights and KV",
        )
    arr = np.ascontiguousarray(tree.astype(np.float32))
    return torch.from_numpy(arr).to(device=torch.device(device), dtype=dtype)


def init_kv_cache(
    cfg: ModelConfig, num_slots: int, max_seq: int, dtype=torch.bfloat16,
    quant=False, device=None,
) -> KVCache:
    """Raw slot cache ``{'k', 'v': [L, num_slots, max_seq, K, D]}``."""
    if quant not in (False, None, "none", ""):
        raise NotPorted(f"KV cache quant={quant!r}", "quantized weights and KV")
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_slots, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


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


def _mlp(cfg: ModelConfig, blk, h):
    gate = _act(cfg, h @ blk["w_gate"]) * (h @ blk["w_up"])
    return gate @ blk["w_down"]


def _qkv_proj(cfg: ModelConfig, blk, h):
    """QKV projections + bias + head split, no rope."""
    b, t, _ = h.shape
    q = h @ blk["wq"]
    k = h @ blk["wk"]
    v = h @ blk["wv"]
    if cfg.attn_bias:  # qwen2: additive bias on the Q/K/V projections
        q = q + blk["bq"].to(q.dtype)
        k = k + blk["bk"].to(k.dtype)
        v = v + blk["bv"].to(v.dtype)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
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


def _block_tail(cfg: ModelConfig, blk, x, attn):
    """Output projection, residuals and the MLP half of one block."""
    b, t = x.shape[:2]
    attn = attn.reshape(b, t, -1) @ blk["wo"]
    if cfg.post_norms:
        attn = _norm(cfg, attn, blk["post_attn_norm"])
    x = x + attn
    mlp = _mlp(cfg, blk, _norm(cfg, x, blk["mlp_norm"]))
    if cfg.post_norms:
        mlp = _norm(cfg, mlp, blk["post_mlp_norm"])
    return x + mlp


def _embed(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.to(torch.float32) * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _logits(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].T.to(x.dtype)).to(torch.float32)
    else:
        logits = (x @ params["lm_head"]).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def apply_blocks(
    cfg: ModelConfig,
    blocks: Params,
    x: torch.Tensor,  # [B, T, Dm] embedded activations
    valid: torch.Tensor,  # [B, T] bool
    store_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run every block over the prompt batch.  Each layer's (k, v) go to
    ``store_kv(layer, k, v)`` when given (prefill_into_cache writes them
    straight into the cache), else they are stacked and returned as
    ``[L, B, T, K, D]``."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    ks, vs = [], []
    for idx in range(cfg.n_layers):
        blk = _layer(blocks, idx)
        q, k, v = _qkv(cfg, blk, _norm(cfg, x, blk["attn_norm"]), positions)
        attn = flash_causal_attention(
            q, k, v, valid, scale=cfg.query_scale, softcap=cfg.attn_softcap,
            window=_layer_window(cfg, idx, t),
        )
        x = _block_tail(cfg, blk, x, attn)
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
    """Full-prompt forward. Returns (logits [B,T,V] fp32, k, v [L,B,T,K,D])."""
    _check_model(cfg, mesh)
    x = _embed(cfg, params, tokens)
    x, ks, vs = apply_blocks(cfg, params["blocks"], x, valid)
    x = _norm(cfg, x, params["final_norm"])
    return _logits(cfg, params, x), ks, vs


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
    """
    _check_model(cfg, mesh)
    _check_cache(kv_cache)
    b, t = tokens.shape
    s_max = kv_cache["k"].shape[2]
    valid = torch.arange(t, device=tokens.device)[None, :] < lengths[:, None]
    t_w = min(t, s_max)

    def store(idx, k, v):
        kv_cache["k"][idx, slots, :t_w] = k[:, :t_w]
        kv_cache["v"][idx, slots, :t_w] = v[:, :t_w]

    x = _embed(cfg, params, tokens)
    x, _, _ = apply_blocks(cfg, params["blocks"], x, valid, store_kv=store)
    rows = torch.arange(b, device=tokens.device)
    last_idx = (lengths - 1).to(torch.long)
    if not return_prompt_logprobs:
        h_last = _norm(cfg, x[rows, last_idx][:, None], params["final_norm"])
        return _logits(cfg, params, h_last)[:, 0], kv_cache
    logits = _logits(cfg, params, _norm(cfg, x, params["final_norm"]))
    last = logits[rows, last_idx]
    lsm = torch.log_softmax(logits[:, :-1], dim=-1)
    scored = torch.gather(lsm, -1, tokens[:, 1:, None].to(torch.long))[..., 0]
    prompt_lps = torch.cat(
        [torch.zeros((b, 1), dtype=torch.float32, device=tokens.device),
         scored.to(torch.float32)], dim=1,
    )
    return last, kv_cache, prompt_lps


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
    cache."""
    _check_model(cfg, mesh)
    _check_cache(kv_cache)
    b = tokens.shape[0]
    s = kv_cache["k"].shape[2]
    if kv_view is None or kv_view > s:
        kv_view = s
    x = _embed(cfg, params, tokens[:, None])  # [B,1,Dm]
    pos2d = positions[:, None]
    in_cache = (positions < s)[:, None, None]
    write_pos = positions.clamp(max=s - 1).to(torch.long)
    slot_ids = torch.arange(b, device=tokens.device)
    for idx in range(cfg.n_layers):
        blk = _layer(params["blocks"], idx)
        q, k, v = _qkv(cfg, blk, _norm(cfg, x, blk["attn_norm"]), pos2d)
        for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
            plane = kv_cache[name][idx]  # [B, S, K, D] view of the cache
            old = plane[slot_ids, write_pos]
            plane[slot_ids, write_pos] = torch.where(in_cache, new, old)
        attn = flash_decode_attention(
            q, kv_cache["k"][idx, :, :kv_view], kv_cache["v"][idx, :, :kv_view],
            positions, scale=cfg.query_scale, softcap=cfg.attn_softcap,
            window=_layer_window(cfg, idx, s),
        )
        x = _block_tail(cfg, blk, x, attn)
    x = _norm(cfg, x, params["final_norm"])
    return _logits(cfg, params, x)[:, 0], kv_cache
