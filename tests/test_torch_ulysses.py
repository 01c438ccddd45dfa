"""The port's Ulysses attention (``ops/ulysses_attention``) against the JAX
package's ``make_ulysses_attention``, on the CPU.

Spawned gloo ranks (``torch_tp_ranks``: two at sp 2, four at sp 4 and at
tp 2 x sp 2) swap their sequence blocks for head blocks, run the inner
full-sequence attention (kernel 1's plain version here, as the wrapper
runs it for CPU tensors) and swap back.  Against the JAX function on a
``cpu_devices`` mesh of the same shape, within tests/test_ulysses.py's
2e-5: with a ragged pad mask, tiny-gemma's sliding window of 8 and its
attention softcap of 50, GQA, and heads sharded on tp outside the swap.
The head-divisibility refusals carry the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.ops.ulysses_attention import make_ulysses_attention
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops.ulysses_attention import check_heads
from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh

from torch_tp_ranks import run_ranks

TOL = 2e-5  # tests/test_ulysses.py
GEMMA = get_config("tiny-gemma")

#: case -> (tp, sp, b, t, h, kh, d, lengths, window, softcap, seed)
CASES = {
    "sp2-pad": (1, 2, 2, 32, 4, 2, 16, (20, 32), None, None, 0),
    "sp2-window": (1, 2, 2, 32, 4, 2, 16, (20, 32), GEMMA.sliding_window,
                   GEMMA.attn_softcap, 1),
    "sp4-window": (1, 4, 2, 32, 4, 4, 16, (32, 13), GEMMA.sliding_window, None, 2),
    "tp2sp2-pad": (2, 2, 2, 32, 8, 4, 16, (27, 32), None, None, 3),
    "tp2sp2-window": (2, 2, 1, 32, 8, 4, 16, (30,), GEMMA.sliding_window,
                      GEMMA.attn_softcap, 4),
}


def _case(spec):
    tp, sp, b, t, h, kh, d, lengths, window, softcap, seed = spec
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    valid = np.arange(t)[None, :] < np.array(lengths)[:, None]
    return dict(mode="ulysses", tp=tp, sp=sp, dtype="float32", q=q, k=k, v=v,
                valid=valid, window=window, softcap=softcap)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world: per-rank {case: output block}}``, one spawn each."""
    out = {}
    for world in (2, 4):
        cases = {name: _case(spec) for name, spec in CASES.items()
                 if spec[0] * spec[1] == world}
        out[world] = run_ranks("sp_attention", world, cases,
                               tmp_path_factory.mktemp(f"ulysses{world}"))
    return out


def _assemble(outs, tp, sp, shape):
    full = np.empty(shape, np.float32)
    t, h = shape[1] // sp, shape[2] // tp
    for r, o in enumerate(outs):
        s_, h_ = (r // tp) % sp, r % tp
        full[:, s_ * t:(s_ + 1) * t, h_ * h:(h_ + 1) * h] = o
    return full


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_matches_jax_make_ulysses_attention(name, ranks, cpu_devices):
    spec = CASES[name]
    tp, sp = spec[:2]
    case = _case(spec)
    mesh = j_make_mesh(tp=tp, sp=sp, devices=cpu_devices[:tp * sp])
    fn = make_ulysses_attention(mesh, "sp", softcap=case["softcap"],
                                head_axis="tp" if tp > 1 else None)
    want = jax.jit(lambda q, k, v, va: fn(q, k, v, va, window=case["window"]))(
        case["q"], case["k"], case["v"], case["valid"])
    got = _assemble([r[name] for r in ranks[tp * sp]], tp, sp,
                    case["q"].shape)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,kh,tp,sp", [(4, 2, 1, 4), (8, 4, 2, 4), (4, 4, 2, 4)])
def test_head_divisibility_refusal_is_the_reference_s(h, kh, tp, sp, cpu_devices):
    mesh = j_make_mesh(tp=tp, sp=sp, devices=cpu_devices[:tp * sp])
    fn = make_ulysses_attention(mesh, "sp", head_axis="tp" if tp > 1 else None)
    x = jnp.zeros((1, 16, h, 8)), jnp.zeros((1, 16, kh, 8))
    with pytest.raises(ValueError) as want:
        fn(x[0], x[1], x[1], jnp.ones((1, 16), bool))
    with pytest.raises(ValueError) as got:
        check_heads(h, kh, sp, tp)
    assert str(got.value) == str(want.value)
    assert "divisible" in str(got.value)


def test_model_refuses_indivisible_heads_in_the_reference_words(cpu_devices):
    """tiny's 2 kv heads do not split over sp 4: the model-level message."""
    jcfg = j_get_config("tiny", sp_mode="ulysses")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(ValueError) as want:
        jt.prefill(jcfg, jp, jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), bool),
                   mesh=j_make_mesh(sp=4, devices=cpu_devices[:4]))
    cfg = get_config("tiny", sp_mode="ulysses")
    params = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    with pytest.raises(ValueError) as got:
        tt.prefill(cfg, params, torch.zeros((1, 16), dtype=torch.long),
                   torch.ones((1, 16), dtype=torch.bool), mesh=Mesh(sp=4))
    assert str(got.value) == str(want.value)
    assert "use sp_mode='ring'" in str(got.value)
