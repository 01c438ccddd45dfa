"""The port's training path (``transformer.loss_fn``, ``parallel/train``,
kernel 1 under autograd) against the JAX package, on the CPU.

- ``loss_fn`` and its gradients against JAX's ``loss_fn`` and
  ``jax.value_and_grad`` on the same fp32 weights and ragged batch, for
  tiny, tiny-gemma (softcaps, post-norms, windows, tied head) and tiny-moe:
  loss within 1e-5, every leaf's gradient within 1e-5 * max|g|.
- Kernel 1's ``torch.autograd.Function`` (``attention_with_grad``) with the
  plain version launched in the kernel's place: its dq/dk/dv against
  ``jax.grad`` of JAX's ``causal_attention`` on the same bf16-rounded
  inputs (GQA, pad masks, a window, a softcap), within 1e-5 * max|g|.
- A dp 2 x tp 2 step on four spawned gloo ranks against JAX's
  ``make_train_step`` on a dp 2 x tp 2 mesh (tests/test_parallel.py's cfg),
  with ragged lengths so the two dp halves hold different valid counts
  (51 and 17): loss within 1e-5, each rank's gradient shard within 1e-5 *
  max|g| of JAX's unsharded gradient, the parameters after one step within
  1e-6 + 1e-5 * |p| of JAX's but for entries whose gradient is within
  1e-5 * max|g| of zero, and those within 2 * lr (``PARAM_TOL``), five
  steps' losses within 1e-4 of JAX's and descending;
  each rank's AdamW moments at its shard's shapes (wq ``[L, Dm, H*D/2]``,
  wo ``[L, H*D/2, Dm]``, embed ``[V/2, Dm]``), ``init_fn`` drawing the same.
- tiny-moe at ep 2 (two ranks): loss and each rank's gradients (its half
  of the experts) against JAX's unsharded ones.
- An sp > 1 mesh refuses training.
- Each differentiable exchange of ``parallel/collectives`` over the four
  ranks: forward under grad bitwise the forward without, backward the
  identity (``all_reduce_sum``), the group sum (``copy_to_group``), this
  rank's slice (``all_gather``) and the reverse shift (``ring_shift``).

The JAX references are computed once per module; the ranks import only
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.ops.attention import causal_attention as j_causal_attention
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu.parallel.train import make_train_step as j_make_train_step
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
from p2p_llm_tunnel_tpu_torch.ops.attention import causal_attention
from p2p_llm_tunnel_tpu_torch.parallel.mesh import make_mesh
from p2p_llm_tunnel_tpu_torch.parallel.sharding import shard_params
from p2p_llm_tunnel_tpu_torch.parallel.train import (
    make_optimizer,
    make_train_step,
    param_leaves,
)

from torch_tp_ranks import run_ranks

PRESETS = ("tiny", "tiny-gemma", "tiny-moe")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5  # times the leaf's max |g|
#: tests/test_parallel.py's cfg (8 query / 4 kv heads, Dm = H * D = 64).
DPTP = dict(n_heads=8, n_kv_heads=4, dim=64, head_dim=8, vocab_size=512)
LR = 1e-2
#: Parameters after one step: AdamW's first update is lr * g / (|g| + eps)
#: per entry, which moves by lr * eps * dg / (|g| + eps)^2 when g moves by
#: dg.  An entry whose gradient is within the gradient tolerance of zero
#: (the rounding of its gradient may flip its sign) can move by up to 2 *
#: lr; every other entry within 1e-6 + 1e-5 * |p| (``_close_params``).
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 5
#: Per-row lengths: the dp halves (rows 0-3, 4-7) hold 51 and 17 tokens.
LENGTHS = np.array([16, 3, 16, 16, 5, 2, 9, 1])
SHARD_SHAPES = {  # leaf -> its [tp 2] shard shape (L 2, Dm 64, H*D 64, V 512)
    ("blocks", "wq"): (2, 64, 32), ("blocks", "wo"): (2, 32, 64),
    ("blocks", "w_down"): (2, 64, 64), ("embed",): (256, 64),
}


def _batch(vocab, lengths, t=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (len(lengths), t)).astype(np.int32)
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return tokens, np.roll(tokens, -1, axis=1), valid


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, path + (k,)).items()}
    return {path: tree}


def _close_grads(got, want, tol=GRAD_TOL):
    """Every leaf of ``got`` within ``tol * max|want|`` of ``want``."""
    want = _flat(want)
    got = _flat(got)
    assert set(got) == set(want)
    for path, ref in want.items():
        np.testing.assert_allclose(got[path], ref, rtol=0,
                                   atol=tol * np.abs(ref).max(), err_msg=str(path))


def _close_params(got, want, grad, what):
    """One step's parameters against the reference's: every entry within
    ``PARAM_TOL`` but those whose reference gradient ``grad`` is within
    ``GRAD_TOL * max|grad|`` of zero, which stay within 2 * lr."""
    diff = np.abs(got - want)
    off = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
    near_zero = np.abs(grad) <= GRAD_TOL * np.abs(grad).max()
    bad = off & ~near_zero
    assert not bad.any(), (f"{what}: {bad.sum()} of {off.size} entries off, max "
                           f"|diff| {diff[bad].max()}")
    assert diff.max() <= 2 * LR, f"{what}: max |diff| {diff.max()}"


def _jax_loss_and_grads(jcfg, params, tokens, targets, valid):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, tokens, targets, valid)))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


# ---------------------------------------------------------------------------
# loss_fn in one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=PRESETS)
def one_process(request):
    """(JAX loss, JAX grads, port loss, port grads) of one preset."""
    preset = request.param
    jcfg = j_get_config(preset)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tokens, targets, valid = _batch(jcfg.vocab_size, [16, 9, 5, 12])
    want_loss, want_grads = _jax_loss_and_grads(jcfg, jp, tokens, targets, valid)
    params = tt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    loss = tt.loss_fn(get_config(preset), params, torch.from_numpy(tokens),
                      torch.from_numpy(targets), torch.from_numpy(valid))
    loss.backward()
    got = {k: v for k, v in _flat(params).items()}
    grads = {}
    for path, leaf in got.items():
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf.grad.numpy()
    return want_loss, want_grads, float(loss.detach()), grads


def test_loss_fn_matches_jax(one_process):
    want, _, got, _ = one_process
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= LOSS_TOL


def test_loss_fn_grads_match_jax_value_and_grad(one_process):
    _, want, _, got = one_process
    _close_grads(got, want)


# ---------------------------------------------------------------------------
# kernel 1 under autograd (the plain version in the kernel's place)
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "gqa": dict(h=4, kh=2),
    "mha-pads": dict(h=2, kh=2, lengths=[12, 5]),
    "gqa-window": dict(h=4, kh=1, window=4, lengths=[12, 9]),
    "gqa-window1": dict(h=4, kh=2, window=1, lengths=[12, 6]),
    "gqa-softcap": dict(h=4, kh=2, softcap=5.0, lengths=[7, 12]),
    "all": dict(h=6, kh=2, window=5, softcap=8.0, lengths=[12, 4], scale=0.3),
}


def _plain_launch(q, k, v, valid, *, scale, softcap, window):
    """What the kernel computes, on the CPU: the plain version on the bf16
    copies the Function hands it."""
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.is_contiguous()
    return causal_attention(q, k, v, valid, scale=scale, softcap=softcap,
                            window=window)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_kernel1_function_grads_match_jax_grad(name):
    case = dict(ATTN_CASES[name])
    b, t, d = 2, 12, 16
    h, kh = case.pop("h"), case.pop("kh")
    lengths = case.pop("lengths", [t, t])
    rng = np.random.default_rng(3)
    # bf16-representable fp32 inputs: the Function's bf16 copies are exact.
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16().float().numpy() for s in ((b, t, h, d), (b, t, kh, d),
                                                     (b, t, kh, d)))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    dout = rng.standard_normal((b, t, h, d)).astype(np.float32)

    def jfn(q, k, v):
        out = j_causal_attention(q, k, v, jnp.asarray(valid), **case)
        return jnp.sum(out * dout)

    want = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.attention_with_grad(tq, tk, tv, torch.from_numpy(valid),
                                 launch=_plain_launch, **case)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(dout))
    for got, ref, nm in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert got.dtype == torch.float32
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(), err_msg=f"d{nm}")
    # The forward is the launch's output (bf16) in the inputs' dtype.
    launched = _plain_launch(*(x.detach().bfloat16() for x in (tq, tk, tv)),
                             torch.from_numpy(valid), scale=case.get("scale"),
                             softcap=case.get("softcap"), window=case.get("window"))
    assert torch.equal(out.detach(), launched.float())


def test_wrapper_on_cpu_is_the_plain_version_under_grad():
    """On CPU tensors the wrapper returns the plain version, which autograd
    differentiates directly (fp32, no bf16 round); no launch is counted."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True) for s in ((2, 8, 4, 16), (2, 8, 2, 16),
                                               (2, 8, 2, 16)))
    valid = torch.ones((2, 8), dtype=torch.bool)
    before = fa.flash_causal_attention.launches
    out = fa.flash_causal_attention(q, k, v, valid, softcap=20.0)
    assert out.grad_fn is not None and "AttentionGrad" not in type(out.grad_fn).__name__
    want = causal_attention(q, k, v, valid, softcap=20.0)
    assert torch.equal(out, want)
    out.sum().backward()
    assert q.grad is not None and fa.flash_causal_attention.launches == before


# ---------------------------------------------------------------------------
# the optimizer, the single-process step and the sp refusal
# ---------------------------------------------------------------------------

def test_make_optimizer_is_optax_adamw():
    """Three steps of ``make_optimizer`` on one tensor equal optax's
    ``adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)`` (the reference's
    ``make_optimizer``) within fp32 rounding."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = make_optimizer({"w": tp}, lr=1e-2)
    for g in grads:
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_single_process_step_matches_jax_step(cpu_devices):
    """``make_train_step`` with no mesh: one step's loss and parameters
    against the JAX step on a one-device mesh, on the same weights."""
    jcfg = j_get_config("tiny")
    jmesh = j_make_mesh(devices=cpu_devices[:1])
    j_init, j_step = j_make_train_step(jcfg, jmesh, lr=LR)
    jp, jstate = j_init(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jp)
    tokens, targets, valid = _batch(jcfg.vocab_size, [16, 7, 11, 2])
    _, jgrads = _jax_loss_and_grads(jcfg, start, tokens, targets, valid)
    jp, _, jloss = j_step(jp, jstate, tokens, targets, valid)
    init_fn, step_fn = make_train_step(get_config("tiny"), lr=LR, device="cpu")
    drawn, _ = init_fn(0)
    assert all(x.requires_grad and x.dtype == torch.float32 for x in param_leaves(drawn))
    params = tt.params_from_numpy(start, "cpu", torch.float32)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    params, _, loss = step_fn(params, make_optimizer(params, LR), tokens, targets, valid)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    want, jgrads = _flat(jax.tree.map(np.asarray, jp)), _flat(jgrads)
    for path, leaf in _flat(params).items():
        _close_params(leaf.detach().numpy(), want[path], jgrads[path], str(path))


@pytest.mark.parametrize("entry", ["loss_fn", "make_train_step"])
def test_sp_mesh_refuses_training(entry):
    """The reference's loss_fn passes no mesh to prefill: sp never trains."""
    cfg = get_config("tiny")
    mesh = make_mesh(sp=2, rank=0)
    with pytest.raises(ValueError, match="passes no mesh to prefill"):
        if entry == "loss_fn":
            params = tt.init_params(cfg, 0, torch.float32, "cpu")
            x = torch.zeros((1, 4), dtype=torch.int32)
            tt.loss_fn(cfg, params, x, x, torch.ones((1, 4), dtype=torch.bool), mesh)
        else:
            make_train_step(cfg, mesh, device="cpu")


# ---------------------------------------------------------------------------
# dp 2 x tp 2 and ep 2 on spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp_tp(cpu_devices):
    """JAX's make_train_step on a dp 2 x tp 2 mesh: its initial weights,
    its unsharded gradient, the parameters after one step and every
    step's loss."""
    jcfg = j_get_config("tiny", **DPTP)
    mesh = j_make_mesh(tp=2, dp=2, devices=cpu_devices[:4])
    init_fn, step_fn = j_make_train_step(jcfg, mesh, lr=LR)
    params, state = init_fn(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, params)
    tokens, targets, valid = _batch(jcfg.vocab_size, LENGTHS)
    _, grads = _jax_loss_and_grads(jcfg, start, tokens, targets, valid)
    losses, after = [], None
    for step in range(STEPS):
        params, state, loss = step_fn(params, state, tokens, targets, valid)
        losses.append(float(loss))
        if step == 0:
            after = jax.tree.map(np.asarray, params)
    return dict(start=start, grads=grads, after=after, losses=losses,
                batch=(tokens, targets, valid))


@pytest.fixture(scope="module")
def jax_ep(cpu_devices):
    jcfg = j_get_config("tiny-moe")
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(2),
                                                 jnp.float32))
    tokens, targets, valid = _batch(jcfg.vocab_size, [16, 4, 11, 9], seed=6)
    loss, grads = _jax_loss_and_grads(jcfg, jp, tokens, targets, valid)
    return dict(params=jp, loss=loss, grads=grads, batch=(tokens, targets, valid))


OPS = ("all_reduce_sum", "copy_to_group", "all_gather", "ring_shift")


def _exchange_inputs(world=4):
    rng = np.random.default_rng(7)
    x = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(world)]
    dy = {op: [rng.standard_normal((2, 3 * world if op == "all_gather" else 3, 4))
               .astype(np.float32) for _ in range(world)] for op in OPS}
    return dict(x=x, dy=dy)


@pytest.fixture(scope="module")
def ranks(jax_dp_tp, jax_ep, tmp_path_factory):
    """One spawn of four ranks (dp 2 x tp 2) and one of two (ep 2)."""
    tokens, targets, valid = jax_dp_tp["batch"]
    four = run_ranks("several", 4, [
        ("train_model", {"dptp": dict(
            preset="tiny", overrides=DPTP, tp=2, dp=2, lr=LR, steps=STEPS,
            params=jax_dp_tp["start"], tokens=tokens, targets=targets,
            valid=valid)}),
        ("collective_grads", _exchange_inputs()),
    ], tmp_path_factory.mktemp("dptp"), timeout_s=300.0)
    tokens, targets, valid = jax_ep["batch"]
    two = run_ranks("train_model", 2, {"ep2": dict(
        preset="tiny-moe", overrides={}, ep=2, lr=LR, steps=1,
        params=jax_ep["params"], tokens=tokens, targets=targets, valid=valid)},
        tmp_path_factory.mktemp("ep2"), timeout_s=300.0)
    return {"dptp": [r[0]["dptp"] for r in four], "ep2": [r["ep2"] for r in two],
            "exchanges": [r[1] for r in four]}


def _shard(full, rank, mesh_kw):
    """Rank ``rank``'s shard of a numpy tree under the port's spec table."""
    preset = "tiny-moe" if "ep" in mesh_kw else "tiny"
    cfg = get_config(preset, **({} if "ep" in mesh_kw else DPTP))
    return shard_params(full, cfg, make_mesh(rank=rank, **mesh_kw))


def test_dp_tp_loss_is_the_global_masked_mean(jax_dp_tp, ranks):
    """Every rank returns JAX's loss: the whole batch's masked mean, though
    the dp halves count 51 and 17 valid tokens."""
    valid = jax_dp_tp["batch"][2]
    assert (valid[:4].sum(), valid[4:].sum()) == (51, 17)
    for r in ranks["dptp"]:
        assert abs(r["losses"][0] - jax_dp_tp["losses"][0]) <= LOSS_TOL


@pytest.mark.parametrize("rank", range(4))
def test_dp_tp_grads_match_jax(rank, jax_dp_tp, ranks):
    """Rank ``rank``'s gradient (summed over dp) is its shard of JAX's
    unsharded gradient."""
    _close_grads(ranks["dptp"][rank]["grads"],
                 _shard(jax_dp_tp["grads"], rank, dict(tp=2, dp=2)))


def test_dp_tp_params_after_one_step_match_jax(jax_dp_tp, ranks):
    for rank, r in enumerate(ranks["dptp"]):
        want = _flat(_shard(jax_dp_tp["after"], rank, dict(tp=2, dp=2)))
        grads = _flat(_shard(jax_dp_tp["grads"], rank, dict(tp=2, dp=2)))
        for path, got in _flat(r["params"]).items():
            _close_params(got, want[path], grads[path], f"rank {rank} {path}")


def test_dp_tp_five_steps_descend_as_jax(jax_dp_tp, ranks):
    want = jax_dp_tp["losses"]
    for r in ranks["dptp"]:
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=1e-4)
        assert r["losses"][-1] < r["losses"][0], r["losses"]


@pytest.mark.parametrize("leaf", sorted(SHARD_SHAPES))
def test_dp_tp_moments_at_the_shard_shape(leaf, ranks):
    """Both AdamW moments of a leaf take its tp shard's shape (wq and wo
    alike: the unsharded shapes coincide, Dm = H * D), as do the leaves
    ``init_fn`` draws."""
    shape = SHARD_SHAPES[leaf]
    for r in ranks["dptp"]:
        node, drawn = r["moments"], r["init_shapes"]
        for k in leaf:
            node, drawn = node[k], drawn[k]
        assert node == (shape, shape) and drawn == shape


@pytest.mark.parametrize("rank", range(2))
def test_ep_loss_and_grads_match_jax(rank, jax_ep, ranks):
    """tiny-moe at ep 2: each rank's loss is JAX's, its gradients JAX's for
    its two of the four experts and for every replicated leaf."""
    r = ranks["ep2"][rank]
    assert abs(r["losses"][0] - jax_ep["loss"]) <= LOSS_TOL
    _close_grads(r["grads"], _shard(jax_ep["grads"], rank, dict(ep=2)))
    assert r["grads"]["blocks"]["moe_gate"].shape[1] == 2


@pytest.mark.parametrize("op", OPS)
def test_exchange_backward(op, ranks):
    """Over four ranks (rank r's input ``x[r]``, cotangent ``dy[r]``)."""
    inputs = _exchange_inputs()
    x, dy = inputs["x"], inputs["dy"][op]
    n = len(x)
    for r, res in enumerate(ranks["exchanges"]):
        y, plain, grad = res[op]
        np.testing.assert_array_equal(y, plain)
        forward, backward = {
            "all_reduce_sum": (None, dy[r]),
            "copy_to_group": (x[r], sum(dy[1:], dy[0])),
            "all_gather": (np.concatenate(x, axis=1), dy[r][:, 3 * r:3 * r + 3]),
            "ring_shift": (x[r - 1], dy[(r + 1) % n]),
        }[op]
        if forward is None:  # a float sum: its order is the backend's
            np.testing.assert_allclose(y, sum(x[1:], x[0]), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(y, forward)
        if op == "copy_to_group":
            np.testing.assert_allclose(grad, backward, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(grad, backward)
