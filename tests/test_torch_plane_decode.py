"""Kernel 3 (the legacy whole-plane decode kernel) of the port, on the CPU:
``ops/decode_attention.flash_decode_attention_plane`` runs its plain version
(``cached_attention``) for CPU tensors; it is held against the JAX
package's ``flash_decode_attention_plane`` in interpret mode at two small
shapes, with and without window and softcap (fp32, within 1e-5: the same
softmax in another summation order) on the live rows.  A parked row (pos
>= S) is compared nowhere: the reference encodes "no window" as S + 1, so
its parked rows skip the plane's first keys, where the port's INT32_MAX
(ROADMAP Queue 3) attends the whole plane, as kernel 2 does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    flash_decode_attention_plane as j_plane,
)
from p2p_llm_tunnel_tpu_torch.models import transformer  # noqa: F401  (import order)
from p2p_llm_tunnel_tpu_torch.ops import decode_attention as da

SHAPES = [(3, 128, 4, 2, 32), (4, 256, 8, 2, 16)]  # (B, S, H, K, D)


@pytest.mark.parametrize("kw", [{}, dict(window=40, softcap=5.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plane_plain_matches_jax_interpret(shape, kw):
    b, s, h, kh, d = shape
    rng = np.random.default_rng(s + len(kw))
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    pos = np.array([0, 77, s - 1, s + 5][:b], np.int32)
    want = j_plane(*[jnp.asarray(x) for x in (q, k, v, pos)], interpret=True, **kw)
    got = da.flash_decode_attention_plane(*[torch.from_numpy(x) for x in (q, k, v, pos)],
                                          **kw)
    live = pos < s  # parked rows: JAX's "no window" is S + 1, the port's INT32_MAX
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-5, rtol=1e-5)


def test_plane_wrapper_needs_whole_128_key_blocks():
    q = torch.zeros((1, 1, 2, 16))
    kv = torch.zeros((1, 100, 1, 16))
    with pytest.raises(ValueError, match="128"):
        da.flash_decode_attention_plane(q, kv, kv, torch.zeros(1, dtype=torch.int32))
