"""Weight and KV-cache quantization — p2p_llm_tunnel_tpu/models/quant.py
in PyTorch.

int4 packing: two int4 values per int8 byte along one axis, element 2i in
the low nibble and 2i+1 in the high nibble (the reference's layout, so a
packed cache means the same bytes in both packages).  The KV cache packs
along the SEQUENCE axis: byte i of a slot row holds tokens 2i and 2i+1.

Every write into a packed plane goes through one of the four helpers
below, and each stores WHOLE bytes: a nibble shared with a neighbouring
token is merged from the byte read back, never half-written.  Unlike the
reference (functional ``.at[].set``), they write IN PLACE and return the
plane.  Rows past the plane's end (parked slots, a padded tail or a verify
burst beyond ``max_seq``) rewrite a byte of their own row with its old
value where XLA's scatter would drop the write — torch indexing past the
end faults on the card.

Weights (the second half of this module): ``QTensor`` (int8, one f32
scale per output channel) and ``QTensor4`` (int4 packed two per byte along
the contracted axis, one f32 scale per group of ``group_size`` contracted
positions and output channel), their quantizers, the products ``mm`` and
``head_matmul`` and the row gather ``embed_lookup``.  The products go
through ``ops/quant_matmul`` (kernel 7): on CUDA tensors the dequant-fused
Hopper kernel, so only packed bytes and scales cross HBM; on CPU tensors
its plain version, which follows the reference's expression op for op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]


def pack_int4(vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int values in [-8, 7] two per byte along ``axis`` (even size):
    element 2i -> low nibble, 2i+1 -> high nibble."""
    axis = axis % vals.dim()
    n = vals.shape[axis]
    if n % 2:
        raise ValueError(f"pack_int4 needs an even axis size, got {n}")
    v = vals.to(torch.int16)
    pairs = v.unflatten(axis, (n // 2, 2))
    lo = pairs.select(axis + 1, 0)
    hi = pairs.select(axis + 1, 1)
    # hi * 16 + low nibble lies in [-128, 127] for hi in [-8, 7]: the int8
    # cast is exact (the reference's (hi << 4) | (lo & 0x0F) on int8).
    return (hi * 16 + (lo & 0x0F)).to(torch.int8)


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) nibbles of int8 bytes as sign-extended int8 values."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4  # arithmetic: the sign of the byte is the high nibble's
    return lo.to(torch.int8), hi.to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: int8 bytes -> int8 values in [-8, 7], the
    packed axis doubling (token 2i from the low nibble, 2i+1 from the
    high)."""
    axis = axis % packed.dim()
    lo, hi = _nibbles(packed)
    return torch.stack([lo, hi], dim=axis + 1).flatten(axis, axis + 1)


def write_packed_prefix(plane: torch.Tensor, slots: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Full-prefix packed write, IN PLACE: ``vals [L, Bp, T(even), K, D]``
    int4 values land at token positions ``[0, T)`` of each slot row of
    ``plane [L, R, S//2, K, D]`` — whole bytes from position 0."""
    packed = pack_int4(vals, axis=2)
    plane[:, slots.to(torch.long), : packed.shape[2]] = packed
    return plane


def write_packed_chunk(plane: torch.Tensor, idx: int, rows: torch.Tensor,
                       bpos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Page-aligned chunk write, IN PLACE: ``vals [Bp, T(even), K, D]`` at
    even token starts, given as byte positions ``bpos [Bp, T//2]`` (byte i
    holds tokens ``start + 2i, start + 2i + 1``).  ``rows [Bp, 1]`` are
    the slots.  Bytes past the plane (a padded tail beyond ``max_seq``)
    rewrite their row's own old byte ``T//2`` bytes earlier — a history
    byte no real write of this call touches."""
    half = bpos.shape[1]
    nbytes = plane.shape[2]
    inside = bpos < nbytes
    wpos = torch.where(inside, bpos, (bpos - half).clamp(min=0)).to(torch.long)
    rows = rows.to(torch.long)
    old = plane[idx, rows, wpos]
    plane[idx, rows, wpos] = torch.where(
        inside[:, :, None, None], pack_int4(vals, axis=1), old)
    return plane


def append_packed_token(plane: torch.Tensor, idx: int, slots: torch.Tensor,
                        positions: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Single-token decode append, IN PLACE: ``vals [B, K, D]`` at
    arbitrary-parity ``positions [B]``.  The new token shares its byte with
    its sequence neighbour, whose nibble must survive: read the covering
    byte, merge the new nibble, store the whole byte.  Rows at positions
    past the plane write their (clamped) byte back unchanged."""
    nbytes = plane.shape[2]
    pos = positions.to(torch.long)
    inside = (pos < 2 * nbytes)[:, None, None]
    bidx = (pos // 2).clamp(max=nbytes - 1)
    slots = slots.to(torch.long)
    old = plane[idx, slots, bidx]  # [B, K, D]
    even = (pos % 2 == 0)[:, None, None]
    old_lo, old_hi = _nibbles(old)
    lo = torch.where(even, vals.to(torch.int8), old_lo).to(torch.int16)
    hi = torch.where(even, old_hi, vals.to(torch.int8)).to(torch.int16)
    merged = (hi * 16 + (lo & 0x0F)).to(torch.int8)
    plane[idx, slots, bidx] = torch.where(inside, merged, old)
    return plane


def splice_packed_rows(plane: torch.Tensor, idx: int, slots: torch.Tensor,
                       starts: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """Arbitrary-start multi-token splice, IN PLACE — the write shape of a
    speculative verify burst: ``vals [B, T, K, D]`` int4 values land at
    token positions ``[starts, starts + T)`` of each slot row, ``starts
    [B]`` of any parity and ``T`` of any parity.  The covering bytes (``T//2
    + 1`` of them span every parity case) are read, unpacked, overlaid with
    the burst's tokens and repacked, and the same whole bytes are stored:
    nibbles outside the burst keep their old value.  Bytes past the plane
    (parked rows at ``start = max_seq``, a burst crossing the end) rewrite
    their row's own old byte ``T//2 + 1`` bytes earlier, before the burst's
    first byte, where XLA's scatter would drop them (the plane must hold
    more than ``2 * (T//2 + 1)`` bytes per row)."""
    b, t = vals.shape[:2]
    nb = t // 2 + 1
    nbytes = plane.shape[2]
    start = starts.to(torch.long)
    bpos = start[:, None] // 2 + torch.arange(nb, device=start.device)[None, :]
    inside = bpos < nbytes  # [B, nb]
    wpos = torch.where(inside, bpos, (bpos - nb).clamp(min=0))
    rows = slots.to(torch.long)[:, None]
    old = plane[idx, rows, wpos]  # [B, nb, K, D]
    old_tok = unpack_int4(old, axis=1)  # [B, 2nb, K, D]
    jrel = (torch.arange(2 * nb, device=start.device)[None, :]
            - (start % 2)[:, None])  # [B, 2nb] burst offset of each token
    use_new = (jrel >= 0) & (jrel < t)
    newv = vals[torch.arange(b, device=start.device)[:, None], jrel.clamp(0, t - 1)]
    merged = torch.where(use_new[:, :, None, None], newv.to(torch.int8), old_tok)
    plane[idx, rows, wpos] = torch.where(
        inside[:, :, None, None], pack_int4(merged, axis=1), old)
    return plane


def quantize_sym(x: torch.Tensor, qmax: float):
    """Symmetric quantization over the last axis -> (values in [-qmax,
    qmax] as f32, scale f32 ``[..., 1]``): scale = max(amax, 1e-8) / qmax,
    values = round(x / scale) clipped — the reference's formula, with the
    IEEE division ``x / scale`` (never a reciprocal multiply) and
    round-half-to-even, so the kernels' quantizers match it bit for bit.
    ``qmax`` divides as a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can move the scale by one
    ulp."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-8) / torch.full_like(amax, qmax)
    return torch.clamp(torch.round(xf / scale), -qmax, qmax), scale


def _quantize_act(x: torch.Tensor):
    """Dynamic per-token symmetric int8 quantization over the last axis:
    ``(xq int8, scale f32 [..., 1])``."""
    xq, xs = quantize_sym(x, 127.0)
    return xq.to(torch.int8), xs


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------

@dataclass
class QTensor:
    """Int8 weight + per-output-channel f32 scale (the reference's
    ``QTensor``).  ``leaf[idx]`` slices both tensors, as the model's layer
    loop slices the stacked ``[L, ...]`` block weights."""

    q: torch.Tensor  # int8, the original weight's shape
    scale: torch.Tensor  # f32, that shape with the contracted axis dropped

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.scale[idx])

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device


@dataclass
class QTensor4:
    """Packed int4 weight + per-group f32 scales (the reference's
    ``QTensor4``): ``q`` holds two values per byte along the contracted
    axis (element 2i in the low nibble, 2i+1 in the high), padded to whole
    groups; ``scale`` has that axis replaced by ``ceil(in_dim /
    group_size)`` groups.  ``axis`` is NEGATIVE, so it keeps pointing at
    the contracted axis after ``leaf[idx]`` drops the leading layer axis."""

    q: torch.Tensor  # int8 bytes; contracted axis holds n_groups*group_size/2
    scale: torch.Tensor  # f32; contracted axis -> n_groups
    in_dim: int  # true contracted length before padding
    group_size: int
    axis: int  # contracted axis, negative

    def __getitem__(self, idx) -> "QTensor4":
        return QTensor4(self.q[idx], self.scale[idx], self.in_dim,
                        self.group_size, self.axis)

    @property
    def shape(self):
        """LOGICAL shape (contracted axis at its true length)."""
        s = list(self.q.shape)
        s[self.axis] = self.in_dim
        return tuple(s)

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (QTensor, QTensor4))


def _quantize(w: torch.Tensor, axis: int) -> QTensor:
    """Symmetric int8 over ``axis`` (the contracted axis): scale =
    max(amax, 1e-8) / 127, q = round(w / scale) clipped — IEEE divisions
    by tensors and round half to even, bit-exact with the reference run
    eagerly."""
    wf = w.to(torch.float32)
    a = wf.abs().amax(dim=axis, keepdim=True)
    scale = a.clamp(min=1e-8) / torch.full_like(a, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.squeeze(axis))


def _quantize4(w: torch.Tensor, axis: int, group_size: int = 128) -> QTensor4:
    """Symmetric int4 over ``axis`` with per-group scales: the contracted
    axis is zero-padded to whole groups (pads quantize to 0), values clip
    to [-7, 7] and pack two per byte along it."""
    if group_size % 2:
        raise ValueError(f"group_size must be even, got {group_size}")
    axis = axis - w.dim() if axis >= 0 else axis
    a = axis % w.dim()
    k = w.shape[a]
    n_groups = -(-k // group_size)
    kp = n_groups * group_size
    wf = w.to(torch.float32)
    if kp != k:
        pad_shape = list(wf.shape)
        pad_shape[a] = kp - k
        wf = torch.cat([wf, wf.new_zeros(pad_shape)], dim=a)
    wg = wf.unflatten(a, (n_groups, group_size))
    amax = wg.abs().amax(dim=a + 1, keepdim=True)
    scale = amax.clamp(min=1e-8) / torch.full_like(amax, 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7).flatten(a, a + 1)
    return QTensor4(q=pack_int4(q, axis=axis), scale=scale.squeeze(a + 1),
                    in_dim=k, group_size=group_size, axis=axis)


def _dequant4(qt: QTensor4, dtype) -> torch.Tensor:
    """Unpack + group-scale multiply in f32 -> the dense weight at its
    LOGICAL shape in ``dtype`` (rounded once, after the multiply)."""
    axis = qt.axis % qt.q.dim()
    vals = unpack_int4(qt.q, axis=axis)
    kp = vals.shape[axis]
    n_groups = kp // qt.group_size
    scale = qt.scale.unsqueeze(axis + 1)  # [.., n_groups, 1, ..]
    deq = (vals.unflatten(axis, (n_groups, qt.group_size)).to(torch.float32)
           * scale).flatten(axis, axis + 1)
    if qt.in_dim != kp:
        deq = deq.narrow(axis, 0, qt.in_dim)
    return deq.to(dtype)


def _int8_dot(x: torch.Tensor, q: torch.Tensor, rhs_contract: int) -> torch.Tensor:
    """W8A8: per-token int8 activations times int8 weights, summed exactly,
    times the activation scale -> f32 ``(x_int8 @ q) * x_scale``; the
    caller applies the weight scale.  The sums are taken in float64, exact
    for int8 products up to K = 2**53 / 127**2 (the reference's int32
    accumulate)."""
    xq, xs = _quantize_act(x)
    w = q if rhs_contract == 0 else q.transpose(0, 1)
    y = xq.to(torch.float64) @ w.to(torch.float64)
    return y.to(torch.float32) * xs


def _kernel7():
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul

    return quant_matmul


def mm(x: torch.Tensor, w, act_quant: bool = False) -> torch.Tensor:
    """x @ w for a plain tensor, a QTensor or a QTensor4 ``[K, N]`` (int4
    packed along K): the quantized products run kernel 7 (its plain
    version on the CPU).  ``act_quant`` selects W8A8 for int8 weights and
    is ignored by int4, as in the reference."""
    if isinstance(w, QTensor4):
        return _kernel7().quant_matmul(x, w.q, w.scale, form="int4", layout="kn",
                                       in_dim=w.in_dim, group_size=w.group_size)
    if isinstance(w, QTensor):
        return _kernel7().quant_matmul(x, w.q, w.scale,
                                       form="w8a8" if act_quant else "int8",
                                       layout="kn")
    return x @ w


def embed_lookup(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather for a plain or quantized embedding table: the gathered
    rows (packed, for int4) dequantize into ``dtype``; the table stays
    quantized."""
    tokens = tokens.to(torch.long)
    if isinstance(embed, QTensor4):
        rows = unpack_int4(embed.q[tokens], axis=-1)  # [.., kp] int8
        n_groups = rows.shape[-1] // embed.group_size
        scales = embed.scale[tokens]  # [.., n_groups]
        deq = (rows.unflatten(-1, (n_groups, embed.group_size)).to(torch.float32)
               * scales[..., None]).flatten(-2)
        return deq[..., : embed.in_dim].to(dtype)
    if isinstance(embed, QTensor):
        rows = embed.q[tokens].to(dtype)
        return rows * embed.scale[tokens][..., None].to(dtype)
    return embed[tokens]


def head_matmul(x: torch.Tensor, embed, act_quant: bool = False) -> torch.Tensor:
    """Tied-head logits ``x @ embed.T`` over a ``[V, dm]`` table: per-row
    dequant after the product (int8) or in the operand (int4, packed along
    dm) — kernel 7 in its contract-the-last-axis layout."""
    if isinstance(embed, QTensor4):
        return _kernel7().quant_matmul(x, embed.q, embed.scale, form="int4",
                                       layout="nk", in_dim=embed.in_dim,
                                       group_size=embed.group_size)
    if isinstance(embed, QTensor):
        return _kernel7().quant_matmul(x, embed.q, embed.scale,
                                       form="w8a8" if act_quant else "int8",
                                       layout="nk")
    return x @ embed.T.to(x.dtype)


_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _refuse_moe(blocks_or_cfg, what: str) -> None:
    moe = ("router" in blocks_or_cfg if isinstance(blocks_or_cfg, dict)
           else getattr(blocks_or_cfg, "n_experts", 0))
    if moe:
        raise NotImplementedError(
            f"{what} quantization of MoE expert weights is not implemented; "
            "serve MoE models with quant='none'"
        )


def _per_layer(fn, w: torch.Tensor):
    """``fn`` over each layer of a stacked ``[L, ...]`` weight, stacked
    back: the f32 copy a quantizer makes stays one layer wide (the whole
    stack's would double an 8B model's peak memory)."""
    parts = [fn(w[i]) for i in range(w.shape[0])]
    first = parts[0]
    if isinstance(first, QTensor4):
        return QTensor4(torch.stack([p.q for p in parts]),
                        torch.stack([p.scale for p in parts]),
                        first.in_dim, first.group_size, first.axis)
    return QTensor(torch.stack([p.q for p in parts]),
                   torch.stack([p.scale for p in parts]))


def quantize_params(params: Params, cfg=None) -> Params:
    """Int8 every matmul weight; norms (and biases) keep their dtype.
    Block weights ``[L, in, out]`` scale per (layer, out channel); the
    embedding per row (serving the gather and the tied head); an untied
    ``lm_head [dm, V]`` per vocab column."""
    del cfg
    blocks = params["blocks"]
    _refuse_moe(blocks, "int8")
    qblocks = dict(blocks)
    for name in _BLOCK_WEIGHTS:
        qblocks[name] = _per_layer(lambda w: _quantize(w, axis=0), blocks[name])
    out: Params = {
        "embed": _quantize(params["embed"], axis=1),
        "blocks": qblocks,
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = _quantize(params["lm_head"], axis=0)
    return out


def quantize_params_int4(params: Params, group_size: int = 128) -> Params:
    """Packed int4 every matmul weight, per-group scales; contracted axes
    stored negative: block weights and ``lm_head`` -> -2, the embedding
    -> -1 (one packing serves the gather and the tied head)."""
    blocks = params["blocks"]
    _refuse_moe(blocks, "int4")
    qblocks = dict(blocks)
    for name in _BLOCK_WEIGHTS:
        qblocks[name] = _per_layer(
            lambda w: _quantize4(w, axis=-2, group_size=group_size), blocks[name])
    out: Params = {
        "embed": _quantize4(params["embed"], axis=-1, group_size=group_size),
        "blocks": qblocks,
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = _quantize4(params["lm_head"], axis=-2,
                                    group_size=group_size)
    return out


def _quantized_tree(cfg, gen: torch.Generator, dev: torch.device, qdense) -> Params:
    """The reference's quantized random-init tree around ``qdense(shape,
    fan_in, axis)``: bf16 norms (zeros for gemma's plus-one norms), bf16
    biases, quantized matmul weights and embedding."""
    l, dm, h, kh, hd, f, v = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.ffn_dim, cfg.vocab_size,
    )
    dtype = torch.bfloat16
    fill = torch.zeros if cfg.post_norms else torch.ones

    def norm(shape):
        return fill(shape, dtype=dtype, device=dev)

    blocks = {
        "attn_norm": norm((l, dm)),
        "mlp_norm": norm((l, dm)),
        "wq": qdense((l, dm, h * hd), dm, -2),
        "wk": qdense((l, dm, kh * hd), dm, -2),
        "wv": qdense((l, dm, kh * hd), dm, -2),
        "wo": qdense((l, h * hd, dm), h * hd, -2),
        "w_gate": qdense((l, dm, f), dm, -2),
        "w_up": qdense((l, dm, f), dm, -2),
        "w_down": qdense((l, f, dm), f, -2),
    }
    if cfg.post_norms:
        blocks["post_attn_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
        blocks["post_mlp_norm"] = torch.zeros((l, dm), dtype=dtype, device=dev)
    if getattr(cfg, "attn_bias", False):
        # Biases stay bf16: 1-D and bandwidth-trivial.
        for name, width in (("bq", h * hd), ("bk", kh * hd), ("bv", kh * hd)):
            b = torch.randn((l, width), generator=gen, device=dev,
                            dtype=torch.float32)
            blocks[name] = (b * dm**-0.5).to(dtype)
    params: Params = {
        "embed": qdense((v, dm), dm, -1),  # per row: gather + tied head
        "blocks": blocks,
        "final_norm": norm((dm,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qdense((dm, v), dm, -2)
    return params


def _random_bytes(shape, low: int, gen: torch.Generator, dev) -> torch.Tensor:
    """int8 values uniform in ``[low, 127]``, drawn in place one leading
    slice at a time (no wider temporary)."""
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    for piece in (out.unbind(0) if len(shape) == 3 else (out,)):
        piece.random_(low, 128, generator=gen)
    return out


def init_params_quantized(cfg, seed: int = 0, device=None) -> Params:
    """Random init directly in int8 on the device: int8 values uniform in
    [-127, 127] from a ``torch.Generator`` seeded with ``seed``, scales
    ``fan_in**-0.5 / 127`` (the bf16 init's magnitude) — no bf16 tree ever
    exists.  Checkpoints quantize with ``quantize_params``."""
    from p2p_llm_tunnel_tpu_torch.models.transformer import resolve_device

    _refuse_moe(cfg, "int8")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qdense(shape, fan_in, axis):
        a = axis % len(shape)
        scale_shape = shape[:a] + shape[a + 1:]
        # The embedding [V, dm] keeps one scale per row; matmul weights
        # [.., in, out] one per output channel.
        return QTensor(_random_bytes(shape, -127, gen, dev),
                       torch.full(scale_shape, fan_in**-0.5 / 127.0,
                                  dtype=torch.float32, device=dev))

    return _quantized_tree(cfg, gen, dev, qdense)


def init_params_quantized_int4(cfg, seed: int = 0, group_size: int = 128,
                               device=None) -> Params:
    """Random init directly in packed int4 on the device: random BYTES
    (each two nibbles in [-8, 7]) and scales ``fan_in**-0.5 / 7``, as the
    reference; the padded tail of the contracted axis is random too (it is
    sliced off or meets zero activations)."""
    from p2p_llm_tunnel_tpu_torch.models.transformer import resolve_device

    _refuse_moe(cfg, "int4")
    if group_size % 2:
        raise ValueError(f"group_size must be even, got {group_size}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qdense(shape, fan_in, axis):
        a = axis % len(shape)
        n_groups = -(-shape[a] // group_size)
        packed = shape[:a] + (n_groups * group_size // 2,) + shape[a + 1:]
        scale_shape = shape[:a] + (n_groups,) + shape[a + 1:]
        return QTensor4(_random_bytes(packed, -128, gen, dev),
                        torch.full(scale_shape, fan_in**-0.5 / 7.0,
                                   dtype=torch.float32, device=dev),
                        in_dim=shape[a], group_size=group_size, axis=axis)

    return _quantized_tree(cfg, gen, dev, qdense)


def _padded_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last-axis rows in whole 16-byte pieces: ``t`` itself
    when they are (or ``t`` is 1-D), else a view ``[..., :n]`` of
    zero-padded storage (same values, same logical shape)."""
    if t.dim() < 2:
        return t
    n, es = t.shape[-1], t.element_size()
    if t.stride(-1) == 1 and t.stride(-2) >= n and (t.stride(-2) * es) % 16 == 0:
        return t
    ld = -(-n * es // 16) * 16 // es
    buf = t.new_zeros(t.shape[:-1] + (ld,))
    buf[..., :n] = t
    return buf[..., :n]


def kernel_layout(params):
    """The tree as kernel 7 reads it on the card: every quantized leaf's
    weight and scale rows in whole 16-byte pieces, which its bulk copies
    need (and which keeps each layer's slice of a stacked leaf 16-byte
    aligned) — a row that is not (an untied head of 259 columns, a
    contracted length no multiple of 16) is stored padded with zeros and
    kept as a view at its logical shape, so every other reader sees the
    same values.  Leaves already so laid out are returned as they are (no
    copy); apply after any ``.to()``, which packs views."""
    if isinstance(params, dict):
        return {k: kernel_layout(v) for k, v in params.items()}
    if isinstance(params, QTensor4):
        return QTensor4(_padded_rows(params.q), _padded_rows(params.scale),
                        params.in_dim, params.group_size, params.axis)
    if isinstance(params, QTensor):
        return QTensor(_padded_rows(params.q), _padded_rows(params.scale))
    return params


def weight_bytes(params) -> int:
    """Bytes of every leaf of a params tree (packed bytes and scales for
    quantized leaves)."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if is_quantized(params):
        return weight_bytes(params.q) + weight_bytes(params.scale)
    return params.numel() * params.element_size()
