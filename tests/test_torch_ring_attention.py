"""The port's ring attention (``ops/ring_attention``) and the exchanges
under it (``parallel/collectives``) against the JAX package, on the CPU.

- Ring attention of spawned gloo ranks (``torch_tp_ranks``: two ranks at
  sp 2; four at sp 4 and at tp 2 x sp 2, heads sharded on tp outside the
  ring) against JAX's ``make_ring_attention`` on a ``cpu_devices`` mesh of
  the same shape: fp32 within 1e-5, bf16 within 5e-2 (the tolerances of
  tests/test_ring_attention.py), with GQA and a softcap.
- Causality: perturbing the last rank's K/V block leaves every earlier
  block's output unchanged, bit for bit, and changes the last.
- Every exchange (the ring shift, both all-to-all swaps, the sequence
  gather; each a zero-padded ``all_reduce``) at sp 2 and 4: bitwise
  equal to the arrangement it stands for, on inputs holding -0.0 and
  NaN.
- The single-device oracle against JAX's, and the model's refusals (ring
  with a sliding window, an unknown ``sp_mode``) in the reference's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.ops.ring_attention import make_ring_attention
from p2p_llm_tunnel_tpu.ops.ring_attention import (
    ring_attention_reference as j_ring_reference,
)
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops.ring_attention import ring_attention_reference
from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh

from torch_tp_ranks import run_ranks

TOL = {"float32": 1e-5, "bfloat16": 5e-2}  # tests/test_ring_attention.py

#: case -> (tp, sp, b, t, h, kh, d, dtype, softcap, seed)
CASES = {
    "sp2-fp32": (1, 2, 2, 32, 4, 2, 16, "float32", None, 0),
    "sp2-bf16": (1, 2, 1, 16, 2, 1, 8, "bfloat16", None, 1),
    "sp4-fp32": (1, 4, 2, 64, 4, 2, 16, "float32", None, 2),
    "sp4-bf16": (1, 4, 1, 32, 4, 1, 8, "bfloat16", None, 3),
    "sp4-softcap": (1, 4, 1, 32, 4, 4, 8, "float32", 30.0, 4),
    "tp2sp2-fp32": (2, 2, 2, 32, 4, 2, 16, "float32", None, 5),
}
CAUSAL = (1, 4, 1, 32, 2, 2, 8, "float32", None, 6)


def _qkv(b, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))


def _case(spec, qkv=None):
    tp, sp, b, t, h, kh, d, dtype, softcap, seed = spec
    q, k, v = qkv if qkv is not None else _qkv(b, t, h, kh, d, seed)
    return dict(mode="ring", tp=tp, sp=sp, dtype=dtype, softcap=softcap, q=q, k=k, v=v)


def _perturbed():
    q, k, v = _qkv(*CAUSAL[2:7], CAUSAL[9])
    rng = np.random.default_rng(9)
    k2, v2 = k.copy(), v.copy()
    k2[:, 24:] = rng.standard_normal(k2[:, 24:].shape)
    v2[:, 24:] = rng.standard_normal(v2[:, 24:].shape)
    return (q, k, v), (q, k2, v2)


def _exchange_inputs(world, seed=11):
    """Per-rank [2, 4, 4, 3] inputs (T and H split over 2 and 4 ranks), each
    holding a -0.0 and a NaN."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((world, 2, 4, 4, 3)).astype(np.float32)
    xs[:, 0, 1, 2, 0] = -0.0
    xs[:, 1, 3, 0, 2] = np.nan
    return list(xs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two ranks (sp 2) and one of four (sp 4, tp 2 x sp 2):
    ``{world: (per-rank attention outputs, per-rank exchanges, inputs)}``."""
    base, pert = _perturbed()
    out = {}
    for world in (2, 4):
        cases = {name: _case(spec) for name, spec in CASES.items()
                 if spec[0] * spec[1] == world}
        if world == 4:
            cases["causal-base"] = _case(CAUSAL, base)
            cases["causal-perturbed"] = _case(CAUSAL, pert)
        xs = _exchange_inputs(world)
        res = run_ranks("several", world,
                        [("sp_attention", cases), ("sp_exchanges", xs)],
                        tmp_path_factory.mktemp(f"ring{world}"))
        out[world] = ([r[0] for r in res], [r[1] for r in res], xs)
    return out


def _assemble(outs, tp, sp, shape):
    """The global array from each rank's (sequence block, head shard)."""
    full = np.empty(shape, np.float32)
    t, h = shape[1] // sp, shape[2] // tp
    for r, o in enumerate(outs):
        s_, h_ = (r // tp) % sp, r % tp
        full[:, s_ * t:(s_ + 1) * t, h_ * h:(h_ + 1) * h] = o
    return full


def _jax_ring(spec, cpu_devices, qkv=None):
    tp, sp, *_rest = spec
    case = _case(spec, qkv)
    dtype = jnp.dtype(case["dtype"])
    mesh = j_make_mesh(tp=tp, sp=sp, devices=cpu_devices[:tp * sp])
    fn = make_ring_attention(mesh, softcap=case["softcap"],
                             head_axis="tp" if tp > 1 else None)
    out = jax.jit(fn)(*(jnp.asarray(case[n], dtype) for n in "qkv"))
    assert out.dtype == dtype
    return np.asarray(out, np.float32)


def _port(ranks, name, spec):
    tp, sp = spec[:2]
    outs = [r[name] for r in ranks[tp * sp][0]]
    b, t, h, d = spec[2], spec[3], spec[4], spec[6]
    return _assemble(outs, tp, sp, (b, t, h, d))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_make_ring_attention(name, ranks, cpu_devices):
    spec = CASES[name]
    want = _jax_ring(spec, cpu_devices)
    got = _port(ranks, name, spec)
    tol = TOL[spec[7]]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ring_causality(ranks, cpu_devices):
    """A perturbed last K/V block (the last rank's) changes nothing before
    it; the port's perturbed output also matches JAX's."""
    base = _port(ranks, "causal-base", CAUSAL)
    pert = _port(ranks, "causal-perturbed", CAUSAL)
    np.testing.assert_array_equal(pert[:, :24], base[:, :24])
    assert not np.allclose(pert[:, 24:], base[:, 24:])
    want = _jax_ring(CAUSAL, cpu_devices, _perturbed()[1])
    np.testing.assert_allclose(pert, want, rtol=TOL["float32"], atol=TOL["float32"])


def _expected(op, xs, r):
    n = len(xs)
    if op == "ring_shift":
        return xs[(r - 1) % n]
    if op == "seq_to_heads":
        return torch.cat([x.tensor_split(n, dim=2)[r] for x in xs], dim=1)
    if op == "heads_to_seq":
        return torch.cat([x.tensor_split(n, dim=1)[r] for x in xs], dim=2)
    return torch.cat(xs, dim=1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["ring_shift", "seq_to_heads", "heads_to_seq",
                                "all_gather"])
def test_exchanges_are_bitwise_exact(op, dtype, world, ranks):
    _, exchanges, inputs = ranks[world]
    xs = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in inputs]
    for r, res in enumerate(exchanges):
        want = _expected(op, xs, r).contiguous()
        shape, got = res[(op, dtype)]
        assert shape == tuple(want.shape), shape
        np.testing.assert_array_equal(got, want.view(torch.uint8).numpy(),
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_jax(dtype):
    q, k, v = _qkv(2, 24, 4, 2, 8, seed=12)
    want = j_ring_reference(*(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v)),
                            softcap=20.0)
    got = ring_attention_reference(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        softcap=20.0)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("preset,overrides,exc", [
    ("tiny-gemma", {}, NotImplementedError),  # ring with a sliding window
    ("tiny", {"sp_mode": "zigzag"}, ValueError),
])
def test_sp_refusals_carry_the_reference_wording(preset, overrides, exc, cpu_devices):
    """Refused before any exchange, with the reference's message."""
    jcfg = j_get_config(preset, **overrides)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(exc) as want:
        jt.prefill(jcfg, jp, jnp.zeros((2, 16), jnp.int32), jnp.ones((2, 16), bool),
                   mesh=j_make_mesh(sp=2, devices=cpu_devices[:2]))
    cfg = get_config(preset, **overrides)
    params = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    with pytest.raises(exc) as got:
        tt.prefill(cfg, params, torch.zeros((2, 16), dtype=torch.long),
                   torch.ones((2, 16), dtype=torch.bool), mesh=Mesh(sp=2))
    assert str(got.value) == str(want.value)
    if exc is NotImplementedError:
        assert "ring" in str(got.value)
