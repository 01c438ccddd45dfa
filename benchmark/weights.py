"""Seeded weights, drawn on the device in the type they are served in.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws every
leaf whole in one call (a stacked ``[layers, ...]`` leaf at once), in
bfloat16: dense weights normal with standard deviation ``fan_in ** -0.5``,
norm weights ``1 + 0.1 * normal`` so the comparison sees them.  The tree has
the layout the served engine takes (``InferenceEngine(params=...)``) and the
reference reads; the same tensors go to both.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import Shape


def draw(shape: Shape, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of ``shape`` from ``seed``: same seed, same bytes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def dense(dims, fan_in):
        t = torch.empty(dims, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    def norm(dims):
        t = torch.empty(dims, dtype=dtype, device=device)
        return t.normal_(1.0, 0.1, generator=gen)

    s = shape
    l, d, f = s.num_hidden_layers, s.hidden_size, s.intermediate_size
    q, kv = s.num_attention_heads * s.head_dim, s.num_key_value_heads * s.head_dim
    blocks = {
        "attn_norm": norm((l, d)),
        "mlp_norm": norm((l, d)),
        "wq": dense((l, d, q), d),
        "wk": dense((l, d, kv), d),
        "wv": dense((l, d, kv), d),
        "wo": dense((l, q, d), q),
    }
    if s.num_local_experts:
        e = s.num_local_experts
        blocks.update({
            "router": dense((l, d, e), d),
            "moe_gate": dense((l, e, d, f), d),
            "moe_up": dense((l, e, d, f), d),
            "moe_down": dense((l, e, f, d), f),
        })
    else:
        blocks.update({
            "w_gate": dense((l, d, f), d),
            "w_up": dense((l, d, f), d),
            "w_down": dense((l, f, d), f),
        })
    return {
        "embed": dense((s.vocab_size, d), d),
        "blocks": blocks,
        "final_norm": norm((d,)),
        "lm_head": dense((d, s.vocab_size), d),
    }


def digest(tree) -> torch.Tensor:
    """One float64 sum per leaf, on the device: a fingerprint that shows
    whether anyone wrote into the weights between two reads."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            leaves.append(torch.stack([c.double().sum() for c in
                                       t.reshape(-1).split(2**26)]).sum())

    walk(tree)
    return torch.stack(leaves)
