"""The PyTorch port's sampler against the JAX package's, on the CPU.

Logits are drawn with numpy (continuous values: no exact argmax ties) and
fed to both samplers.  Greedy choices — with logit bias and frequency /
presence penalties, which shift greedy decoding too — must be identical.
Logprob values match at fp32 (atol 1e-5: logsumexp in another order).
Seeded draws cannot reproduce ``jax.random``; the port keeps the
reference's contract instead: a row's draw is a pure function of (seed,
position), whatever else the batch holds, and the draws follow the
truncated softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.engine import sampling as js
from p2p_llm_tunnel_tpu_torch.engine import sampling as ts

V = 97


def _logits(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, V)).astype(np.float32) * 3


def _jparams(p: ts.SamplingParams) -> js.SamplingParams:
    return js.SamplingParams(*(None if x is None else jnp.asarray(x) for x in p))


def _both_sample(logits, p, counts=None, bias=None, pos=None):
    want = js.sample(
        jnp.asarray(logits), _jparams(p), jax.random.PRNGKey(0),
        counts=None if counts is None else jnp.asarray(counts),
        pos=None if pos is None else jnp.asarray(pos),
        bias=None if bias is None else jnp.asarray(bias),
    )
    got = ts.sample(
        torch.from_numpy(logits), p,
        counts=None if counts is None else torch.from_numpy(counts),
        pos=None if pos is None else torch.from_numpy(pos),
        bias=None if bias is None else torch.from_numpy(bias),
    )
    return got.numpy(), np.asarray(want)


def test_greedy_identical_to_jax():
    logits = _logits(16)
    got, want = _both_sample(logits, ts.make_params(16))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, logits.argmax(-1))


@pytest.mark.parametrize("freq,pres", [(0.7, 0.0), (0.0, 1.5), (-0.5, 0.8)])
def test_penalties_identical_to_jax(freq, pres):
    b = 12
    logits = _logits(b, seed=1)
    counts = np.random.default_rng(2).integers(0, 4, size=(b, V)).astype(np.int32)
    p = ts.make_params(b, freq_pen=freq, pres_pen=pres)
    got, want = _both_sample(logits, p, counts=counts)
    np.testing.assert_array_equal(got, want)
    assert (got != logits.argmax(-1)).any()  # the penalties did move choices


def test_logit_bias_identical_to_jax():
    b = 6
    logits = _logits(b, seed=3)
    bias = np.zeros((b, V), np.float32)
    bias[0, 5] = 100.0  # forces token 5
    bias[1, logits[1].argmax()] = -100.0  # bans the argmax
    bias[3, [7, 9]] = [2.5, -1.0]
    p = ts.make_params(b)._replace(bias_on=np.array([1, 1, 0, 1, 0, 0], bool))
    got, want = _both_sample(logits, p, bias=bias)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 5 and got[1] != logits[1].argmax()


def test_logprob_data_matches_jax():
    logits = _logits(5, seed=4)
    sampled = logits.argmax(-1).astype(np.int32)
    want = js.logprob_data(jnp.asarray(logits), jnp.asarray(sampled))
    got = ts.logprob_data(torch.from_numpy(logits), torch.from_numpy(sampled))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)
    assert ts.lp_width(V) == js.lp_width(V) == ts.TOP_LOGPROBS_CAP
    empty = ts.empty_logprob_data(5, 7)
    assert [tuple(x.shape) for x in empty] == [(5,), (5, 7), (5, 7)]


def test_stochastic_truncation_matches_greedy_limits():
    """top_k=1, or a nucleus smaller than the top token's mass, leaves one
    candidate: the draw must be the greedy token, as in the reference."""
    b = 8
    logits = _logits(b, seed=5)
    pos = np.arange(b, dtype=np.int32)
    for p in (ts.make_params(b, temperature=1.3, top_k=1, seed=11),
              ts.make_params(b, temperature=0.8, top_p=1e-6, seed=12)):
        got, want = _both_sample(logits, p, pos=pos)
        np.testing.assert_array_equal(got, logits.argmax(-1))
        np.testing.assert_array_equal(want, logits.argmax(-1))


def test_seeded_draw_is_independent_of_batch_composition():
    logits = _logits(4, seed=6)
    seeds = np.array([7, 7, 123, 99], np.uint32)
    pos = np.array([10, 11, 10, 50], np.int32)
    p = ts.make_params(4, temperature=1.0)._replace(seed=seeds)
    full = ts.sample(torch.from_numpy(logits), p, pos=torch.from_numpy(pos)).numpy()
    # The same rows in another order, with strangers in the batch.
    order = [3, 0, 2, 1]
    other = np.concatenate([logits[order], _logits(3, seed=9)])
    p2 = ts.make_params(7, temperature=1.0)._replace(
        seed=np.concatenate([seeds[order], np.array([1, 2, 3], np.uint32)]))
    pos2 = np.concatenate([pos[order], np.array([0, 1, 2], np.int32)])
    part = ts.sample(torch.from_numpy(other), p2, pos=torch.from_numpy(pos2)).numpy()
    np.testing.assert_array_equal(part[:4], full[order])
    again = ts.sample(torch.from_numpy(logits), p, pos=torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(again, full)


def test_seeded_draws_follow_the_truncated_softmax():
    """Draws over many positions of one seed: empirical frequencies of the
    top-k candidates match softmax(logits / T) renormalised over them
    (4000 draws: 4 sigma of a binomial at p ~ 0.3 is ~0.03)."""
    n = 4000
    row = np.linspace(-1.0, 1.0, V).astype(np.float32)
    logits = np.repeat(row[None], n, axis=0)
    p = ts.make_params(n, temperature=0.5, top_k=4, seed=2024)
    pos = np.arange(n, dtype=np.int32)
    draws = ts.sample(torch.from_numpy(logits), p, pos=torch.from_numpy(pos)).numpy()
    top = np.argsort(row)[::-1][:4]
    assert set(draws.tolist()) <= set(top.tolist())
    want = np.exp(row[top] / 0.5)
    want /= want.sum()
    got = np.array([(draws == t).mean() for t in top])
    np.testing.assert_allclose(got, want, atol=0.035)
