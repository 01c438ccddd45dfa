"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages.  Plain
ops (rope, rms_norm, the three attention oracles) are compared at fp32
with atol 1e-5 / rtol 1e-4: the same expression graph, only the
summation order of the einsums differs.  The two kernel wrappers run
their plain versions on CPU tensors; those are held against the JAX
Pallas kernels run in interpret mode (as tests/test_pallas_attention.py
and tests/test_pallas_decode.py run them) at atol/rtol 2e-5, the
tolerance those tests give the Pallas kernels against the einsum oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.ops import attention as jattn
from p2p_llm_tunnel_tpu.ops.norms import rms_norm as j_rms_norm
from p2p_llm_tunnel_tpu.ops.pallas_attention import (
    flash_causal_attention as j_flash_causal,
)
from p2p_llm_tunnel_tpu.ops.pallas_decode_attention import (
    flash_decode_attention_sgrid as j_flash_decode,
)
from p2p_llm_tunnel_tpu.ops.rope import apply_rope as j_apply_rope
from p2p_llm_tunnel_tpu_torch.ops import attention as tattn
from p2p_llm_tunnel_tpu_torch.ops.decode_attention import flash_decode_attention
from p2p_llm_tunnel_tpu_torch.ops.flash_attention import flash_causal_attention
from p2p_llm_tunnel_tpu_torch.ops.norms import rms_norm
from p2p_llm_tunnel_tpu_torch.ops.rope import apply_rope

FP32 = dict(atol=1e-5, rtol=1e-4)
PALLAS = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(*arrays):
    """(jax arrays, torch tensors) of the same numpy inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    (jx, jp), (tx, tp) = _both(x, pos)
    want = np.asarray(j_apply_rope(jx, jp, theta))
    got = apply_rope(tx, tp, theta).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(1)
    x, w = _normal(rng, 3, 5, 64), _normal(rng, 64)
    (jx, jw), (tx, tw) = _both(x, w)
    want = np.asarray(j_rms_norm(jx, jw, 1e-5, plus_one=plus_one))
    got = rms_norm(tx, tw, 1e-5, plus_one=plus_one).numpy()
    np.testing.assert_allclose(got, want, **FP32)


CAUSAL_CASES = [
    # (h, kh, lengths, window, softcap)
    (4, 4, [9, 9], None, None),
    (4, 2, [9, 5], None, None),
    (8, 2, [9, 3], 4, None),
    (4, 1, [7, 9], None, 20.0),
]


@pytest.mark.parametrize("h,kh,lengths,window,softcap", CAUSAL_CASES)
def test_causal_attention_matches_jax(h, kh, lengths, window, softcap):
    rng = np.random.default_rng(2)
    b, t, d = len(lengths), 9, 16
    q, k, v = _normal(rng, b, t, h, d), _normal(rng, b, t, kh, d), _normal(rng, b, t, kh, d)
    valid = np.arange(t)[None, :] < np.array(lengths)[:, None]
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, valid)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(jattn.causal_attention(jq, jk, jv, jm, **kw))
    got = tattn.causal_attention(tq, tk, tv, tm, **kw).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("h,kh,window,softcap", [
    (4, 2, None, None), (8, 2, 5, None), (4, 4, None, 30.0),
])
def test_cached_attention_matches_jax(h, kh, window, softcap):
    rng = np.random.default_rng(3)
    b, s, d = 4, 24, 16
    q, kc, vc = _normal(rng, b, 1, h, d), _normal(rng, b, s, kh, d), _normal(rng, b, s, kh, d)
    pos = np.array([0, 11, 23, 40], np.int32)  # last row parked past S
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(q, kc, vc, pos)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(jattn.cached_attention(jq, jk, jv, jp, **kw))
    got = tattn.cached_attention(tq, tk, tv, tp, **kw).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("window", [None, 6])
def test_history_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    b, t, s, h, kh, d = 3, 5, 32, 4, 2, 16
    q, kc, vc = _normal(rng, b, t, h, d), _normal(rng, b, s, kh, d), _normal(rng, b, s, kh, d)
    starts = np.array([0, 7, 20], np.int32)
    (jq, jk, jv, js), (tq, tk, tv, ts) = _both(q, kc, vc, starts)
    want = np.asarray(jattn.history_attention(jq, jk, jv, js, window=window))
    got = tattn.history_attention(tq, tk, tv, ts, window=window).numpy()
    np.testing.assert_allclose(got, want, **FP32)


# -- the kernels' plain versions against the Pallas kernels (interpret) ------

@pytest.mark.parametrize("lengths,window,softcap", [
    ([128, 70], None, None),  # valid padding
    ([128, 128], 40, 30.0),  # sliding window + softcap
])
def test_prefill_plain_matches_pallas_interpret(lengths, window, softcap):
    rng = np.random.default_rng(5)
    b, t, h, kh, d = 2, 128, 4, 2, 32  # GQA 4/2; the TPU kernel needs T % 128
    q, k, v = _normal(rng, b, t, h, d), _normal(rng, b, t, kh, d), _normal(rng, b, t, kh, d)
    valid = np.arange(t)[None, :] < np.array(lengths)[:, None]
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, valid)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(j_flash_causal(jq, jk, jv, jm, interpret=True, **kw))
    got = flash_causal_attention(tq, tk, tv, tm, **kw).numpy()
    np.testing.assert_allclose(got, want, **PALLAS)


@pytest.mark.parametrize("window,softcap", [(None, None), (100, 30.0)])
def test_decode_plain_matches_pallas_interpret(window, softcap):
    rng = np.random.default_rng(6)
    b, s, h, kh, d = 5, 512, 4, 2, 32  # two 256-key S-blocks, GQA 4/2
    q, kc, vc = _normal(rng, b, 1, h, d), _normal(rng, b, s, kh, d), _normal(rng, b, s, kh, d)
    # Positions at S-block edges, plus one parked row (pos >= S) whose
    # output is junk the engine discards: excluded from the comparison.
    pos = np.array([255, 256, 0, 511, 700], np.int32)
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(q, kc, vc, pos)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(j_flash_decode(jq, jk, jv, jp, interpret=True, **kw))
    got = flash_decode_attention(tq, tk, tv, tp, **kw).numpy()
    np.testing.assert_allclose(got[:4], want[:4], **PALLAS)
    assert np.isfinite(got[4]).all()


def test_wrappers_reject_unplaced_tensors():
    """A wrapper takes the plain version only for CPU tensors; any other
    device it cannot launch on raises instead of falling back."""
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_causal_attention(q, q[:, :, :1], q[:, :, :1],
                               torch.ones((1, 4), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        flash_decode_attention(q[:, :1], q, q, torch.zeros((1,), dtype=torch.int32,
                                                           device="meta"))
