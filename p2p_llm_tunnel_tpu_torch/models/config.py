"""Model architecture configs.

Covers the BASELINE.md graduation ladder: a tiny CPU-testable config, the
Gemma-2 2B and Llama-3 8B single-chip targets, and Llama-3 70B for
tensor-parallel v5e-8.  Architectural knobs cover both families:

- llama-style: RMSNorm(w), SwiGLU, GQA, rope, untied head (8B/70B)
- gemma2-style: RMSNorm(1+w), GeGLU, pre+post norms, logit/attn softcap,
  alternating sliding-window attention, tied embeddings
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"  # "silu" (llama SwiGLU) | "gelu" (gemma GeGLU)
    tie_embeddings: bool = False
    # gemma2-specific behaviors (all inert when at defaults):
    post_norms: bool = False  # extra RMSNorm after attn/mlp blocks
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # "alternating" (gemma-2: even layers local) or "all" (mistral: every
    # layer windowed); ignored when sliding_window is None.
    window_pattern: str = "alternating"
    embed_scale: bool = False  # multiply embeddings by sqrt(dim)
    # qwen2-style additive bias on the Q/K/V projections only (o_proj and
    # MLP stay bias-free); adds bq/bk/bv leaves to the block pytree.
    attn_bias: bool = False
    # attention score scale; None → 1/sqrt(head_dim)
    query_scale: Optional[float] = None
    # Use the Pallas flash kernel for prefill attention when the backend is
    # TPU and shapes tile (T%128==0, head_dim%128==0).  Under a tp mesh the
    # kernel runs per head-shard via shard_map (GSPMD does not
    # auto-partition pallas_call).
    flash: bool = True
    # Run the flash kernel in Pallas interpret mode even off-TPU — CPU-mesh
    # tests of the shard_map'd kernel path set this.
    flash_interpret: bool = False
    # Assume the TPU backend when gating Pallas decode kernels, WITHOUT
    # interpret mode: for cross-platform LOWERING only (the launch-count
    # probe lowers the real TPU program from a CPU host — utils/hlo.py).
    # A program traced with this set must never execute off-TPU.
    flash_force: bool = False
    # W8A8: quantize activations dynamically (per-token int8) so QTensor
    # matmuls run as native int8×int8 MXU dots — set by the engine when
    # EngineConfig.quant == "w8a8".  Inert for non-quantized params.
    act_quant: bool = False
    # Use the Pallas decode-attention kernel (ops/pallas_decode_attention)
    # for slot decode when the backend is TPU and shapes tile (view and
    # head_dim % 128 == 0).  Off by default: the einsum path is the oracle;
    # flip on once measured faster for the target config.
    flash_decode: bool = False
    # With flash_decode: use the S-gridded variant (per-block DMA, frontier
    # skips the fetch too, no view-size cap) instead of the full-plane one.
    # Both flags route to the s-grid family — the plane
    # kernel's whole-view DMA is its documented weakness and it is kept
    # only as an interpret-mode cross-check.
    flash_sgrid: bool = False
    # Fused decode-layer Pallas kernel: one program per layer
    # performs rope + new-row KV quantization + the cache append (in-place
    # aliased row write) + frontier-clamped flash attention, collapsing
    # the 6-8 XLA kernels the unfused path launches per layer per step.
    # Composes with every kv_quant mode and every weight quant.  Off by
    # default until chip-measured; correctness is oracle-pinned
    # (tests/test_fused_decode_layer.py).
    fused_decode_layer: bool = False
    # Sequence-parallel strategy when the mesh has sp > 1:
    # "ring"    — K/V blocks rotate via ppermute (bandwidth-optimal on the
    #             ICI ring; no sliding-window support)
    # "ulysses" — one all_to_all swaps the sequence shard for a head shard,
    #             plain attention runs over the full context (windows and
    #             pad masks work; needs H and K divisible by sp)
    sp_mode: str = "ring"
    # Mixture-of-experts (mixtral-style): 0 = dense MLP.  With n_experts
    # set, each block's MLP becomes a router + per-expert SwiGLU, top-k
    # routed with renormalized weights; expert weights shard over an
    # ``ep`` mesh axis (expert parallelism — models/moe.py).
    n_experts: int = 0
    n_experts_per_tok: int = 2

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def tiny(vocab_size: int = 512) -> ModelConfig:
    """CPU-testable config: compiles in seconds, exercises GQA + rope."""
    return ModelConfig(
        name="tiny",
        vocab_size=vocab_size,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_dim=128,
    )


def tiny_gemma(vocab_size: int = 512) -> ModelConfig:
    """Tiny config exercising every gemma2 code path on CPU."""
    return ModelConfig(
        name="tiny-gemma",
        vocab_size=vocab_size,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_dim=128,
        act="gelu",
        tie_embeddings=True,
        post_norms=True,
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=8,
        embed_scale=True,
    )


def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        vocab_size=256128,
        dim=2304,
        n_layers=26,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        ffn_dim=9216,
        rope_theta=10000.0,
        norm_eps=1e-6,
        act="gelu",
        tie_embeddings=True,
        post_norms=True,
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=4096,
        embed_scale=True,
        query_scale=256**-0.5,
    )


def llama3_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        vocab_size=128256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        ffn_dim=14336,
        rope_theta=500000.0,
        norm_eps=1e-5,
    )


def llama32_1b() -> ModelConfig:
    """Llama-3.2-1B: tied embeddings, GQA 32/8, head_dim 64 — the smallest
    real-checkpoint target (fits any chip; good for the opt-in
    tests/test_real_checkpoint.py smoke)."""
    return ModelConfig(
        name="llama3.2-1b",
        vocab_size=128256,
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        ffn_dim=8192,
        rope_theta=500000.0,
        norm_eps=1e-5,
        tie_embeddings=True,
    )


def llama32_3b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        vocab_size=128256,
        dim=3072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        ffn_dim=8192,
        rope_theta=500000.0,
        norm_eps=1e-5,
        tie_embeddings=True,
    )


def mistral_7b() -> ModelConfig:
    """Mistral-7B-v0.1: llama-style with a 4096 sliding window on EVERY
    layer (the arch that popularised windowed attention for serving)."""
    return ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        ffn_dim=14336,
        rope_theta=10000.0,
        norm_eps=1e-5,
        sliding_window=4096,
        window_pattern="all",
    )


def qwen2_7b() -> ModelConfig:
    """Qwen2-7B: llama-style blocks + QKV bias, large vocab, theta=1e6."""
    return ModelConfig(
        name="qwen2-7b",
        vocab_size=152064,
        dim=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        ffn_dim=18944,
        rope_theta=1000000.0,
        norm_eps=1e-6,
        attn_bias=True,
    )


def tiny_qwen() -> ModelConfig:
    """Tiny config exercising the qwen2 code path (QKV bias) on CPU."""
    return ModelConfig(
        name="tiny-qwen",
        vocab_size=256 + 3,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_dim=128,
        attn_bias=True,
    )


def llama3_70b() -> ModelConfig:
    return ModelConfig(
        name="llama3-70b",
        vocab_size=128256,
        dim=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        ffn_dim=28672,
        rope_theta=500000.0,
        norm_eps=1e-5,
    )


def tiny_moe(vocab_size: int = 512) -> ModelConfig:
    """Tiny mixture-of-experts config: 4 experts, top-2 — CPU-testable
    coverage for the MoE block and expert-parallel sharding."""
    return ModelConfig(
        name="tiny-moe",
        vocab_size=vocab_size,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_dim=128,
        n_experts=4,
        n_experts_per_tok=2,
    )


def mixtral_8x7b() -> ModelConfig:
    """Mixtral-8x7B: llama-style attention, 8-expert top-2 SwiGLU MLPs."""
    return ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        ffn_dim=14336,
        rope_theta=1000000.0,
        norm_eps=1e-5,
        sliding_window=None,
        n_experts=8,
        n_experts_per_tok=2,
    )


PRESETS = {
    "tiny": tiny,
    "tiny-qwen": tiny_qwen,
    "tiny-moe": tiny_moe,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny-gemma": tiny_gemma,
    "gemma2-2b": gemma2_2b,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3.2-1b": llama32_1b,
    "llama3.2-3b": llama32_3b,
    "mistral-7b": mistral_7b,
    "qwen2-7b": qwen2_7b,
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        from dataclasses import replace

        cfg = replace(cfg, **overrides)
    return cfg
