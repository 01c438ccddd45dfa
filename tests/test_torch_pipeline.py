"""The port's pipeline parallelism (``parallel/pipeline``) against the JAX
package, on the CPU — the port's twin of tests/test_pipeline.py.

- ``pipeline_prefill`` of two spawned gloo ranks (one stage each) at
  (pp, n_micro) = (2, 4) and (2, 2), and in this process at (1, 2),
  within 2e-4 of JAX's ``prefill`` on the same fp32 weights; tiny-gemma's
  knobs (post-norms, softcaps, alternating windows placed by the stage's
  layer offset, tied head) at (2, 4).
- ``pipeline_loss_fn``'s loss within 1e-4 and every leaf's gradient within
  5e-4 of JAX's unsharded ``value_and_grad`` of ``loss_fn``, on every
  stage: its own layers, and each replicated leaf (embed, final_norm,
  lm_head) whole — on tiny (untied head) and tiny-gemma (the tied head,
  whose gradient gathers stage 0's lookup and every stage's head once).
- The refusals: ``n_micro`` not dividing the batch, pp not dividing the
  layers, a pp mesh larger than the world; each stage's slice of the
  weights.  (The exchanges' backward is tests/test_torch_train.py's.)

The JAX references are computed once per module; the ranks import only
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipeline_prefill,
    shard_params_pp,
)

from torch_tp_ranks import run_ranks

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = 1e-4
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
#: name -> (preset, pp, n_micro, batch, width, with gradients)
CASES = {
    "pp2-m4": ("tiny", 2, 4, 8, 16, False),
    "pp2-m2": ("tiny", 2, 2, 8, 16, False),
    "pp1-m2": ("tiny", 1, 2, 8, 16, False),
    "gemma-pp2-m4": ("tiny-gemma", 2, 4, 8, 16, False),
    "grads-tiny": ("tiny", 2, 2, 4, 8, True),
    "grads-gemma": ("tiny-gemma", 2, 2, 4, 8, True),
}


def _setup(preset, b, t, seed=0):
    """tests/test_pipeline.py's weights and ragged batch, as numpy."""
    cfg = j_get_config(preset)
    params = jt.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 1), (b, t), 0, cfg.vocab_size)
    lengths = jax.random.randint(jax.random.PRNGKey(seed + 2), (b,), 4, t + 1)
    valid = jnp.arange(t)[None, :] < lengths[:, None]
    return cfg, params, tokens, valid


@pytest.fixture(scope="module")
def reference():
    """Per case: the inputs as numpy and JAX's prefill logits (and, for the
    gradient cases, the unsharded loss and gradients)."""
    out = {}
    for name, (preset, pp, n_micro, b, t, grads) in CASES.items():
        cfg, params, tokens, valid = _setup(preset, b, t)
        logits, _, _ = jax.jit(lambda p: jt.prefill(cfg, p, tokens, valid))(params)
        case = dict(preset=preset, pp=pp, n_micro=n_micro,
                    params=jax.tree.map(np.asarray, params),
                    tokens=np.asarray(tokens), valid=np.asarray(valid),
                    logits=np.asarray(logits))
        if grads:
            targets = jnp.roll(tokens, -1, axis=1)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: jt.loss_fn(cfg, p, tokens, targets, valid)))(params)
            case.update(targets=np.asarray(targets), loss=float(loss),
                        grads=jax.tree.map(np.asarray, g))
        out[name] = case
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """One spawn of two ranks, a stage each, running every pp 2 case."""
    keys = ("preset", "n_micro", "params", "tokens", "valid", "targets")
    cases = {name: {k: c[k] for k in keys if k in c}
             for name, c in reference.items() if c["pp"] == 2}
    res = run_ranks("pipeline_model", 2, cases, tmp_path_factory.mktemp("pp2"),
                    timeout_s=300.0)
    return {"pp": res}


def _run_in_process(case):
    cfg = get_config(case["preset"])
    mesh = make_pp_mesh(case["pp"])
    stage = shard_params_pp(tt.params_from_numpy(case["params"], "cpu",
                                                 torch.float32), mesh)
    with torch.no_grad():
        return pipeline_prefill(cfg, stage, torch.from_numpy(case["tokens"]),
                                torch.from_numpy(case["valid"]), mesh,
                                case["n_micro"]).numpy()


@pytest.mark.parametrize("name", ["pp2-m4", "pp2-m2", "pp1-m2"])
def test_pipeline_matches_prefill_oracle(name, reference, ranks):
    case = reference[name]
    if case["pp"] == 1:
        got = [_run_in_process(case)]
    else:
        got = [r[name]["logits"] for r in ranks["pp"]]
        assert [r[name]["layers"][0] for r in ranks["pp"]] == [1, 1]
    for logits in got:
        np.testing.assert_allclose(logits, case["logits"], **LOGIT_TOL)


def test_pipeline_matches_oracle_gemma_knobs(reference, ranks):
    """Post-norms, softcaps, sliding windows and the tied head survive the
    stage split (the layer offset keeps gemma's alternating windows on the
    right layers)."""
    for r in ranks["pp"]:
        np.testing.assert_allclose(r["gemma-pp2-m4"]["logits"],
                                   reference["gemma-pp2-m4"]["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("name", ["grads-tiny", "grads-gemma"])
@pytest.mark.parametrize("rank", range(2))
def test_pipeline_loss_and_grads_match(name, rank, reference, ranks):
    """Backward through the ring-shift chain: the loss and every stage's
    gradients equal the unsharded step's — its own layers' slice, and the
    replicated leaves whole (counted once, not once a stage)."""
    case, got = reference[name], ranks["pp"][rank][name]
    assert abs(got["loss"] - case["loss"]) <= LOSS_TOL
    want = dict(case["grads"])
    want["blocks"] = {k: v[rank:rank + 1] for k, v in want["blocks"].items()}
    assert set(got["grads"]) == set(want)
    for key, ref in want.items():
        pairs = (ref.items() if key == "blocks"
                 else [(None, ref)])
        for leaf, r in pairs:
            g = got["grads"][key] if leaf is None else got["grads"][key][leaf]
            np.testing.assert_allclose(g, r, **GRAD_TOL, err_msg=f"{key} {leaf}")


@pytest.mark.parametrize("what", ["n_micro", "layers"])
def test_pipeline_validates_divisibility(what, reference):
    case = reference["pp1-m2"]
    cfg = get_config("tiny")
    params = tt.params_from_numpy(case["params"], "cpu", torch.float32)
    tokens, valid = torch.from_numpy(case["tokens"]), torch.from_numpy(case["valid"])
    if what == "n_micro":
        with pytest.raises(ValueError, match="n_micro"):
            pipeline_prefill(cfg, params, tokens, valid, make_pp_mesh(1), 3)
    else:
        with pytest.raises(ValueError, match="not divisible by pp=3"):
            pipeline_prefill(cfg, params, tokens, valid, make_pp_mesh(3, rank=0), 2)


@pytest.mark.parametrize("rank", range(2))
def test_shard_params_pp_keeps_the_stage_layers(rank, reference):
    """Stage ``rank`` holds layer ``rank`` of every block leaf (a fresh
    tensor) and the replicated leaves as they are (no copy)."""
    full = tt.params_from_numpy(reference["grads-tiny"]["params"], "cpu",
                                torch.float32)
    stage = shard_params_pp(full, make_pp_mesh(2, rank=rank))
    for k, v in full["blocks"].items():
        assert torch.equal(stage["blocks"][k], v[rank:rank + 1])
        assert stage["blocks"][k].data_ptr() != v[rank:rank + 1].data_ptr()
    for k in ("embed", "final_norm", "lm_head"):
        assert stage[k].data_ptr() == full[k].data_ptr()
        assert torch.equal(stage[k], full[k])


def test_make_pp_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="pp=2 needs 2 ranks, have 1"):
        make_pp_mesh(2)
    mesh = make_pp_mesh(1)
    assert (mesh.pp, mesh.rank, mesh.group) == (1, 0, None)
