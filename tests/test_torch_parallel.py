"""The port's tensor parallelism (``p2p_llm_tunnel_tpu_torch/parallel``)
against the JAX package's, on the CPU.

- Mesh rules: the axes, the rank -> tp coordinate map, ``best_mesh``'s
  rule (``best_tp`` against the JAX ``best_mesh`` on the 8 virtual CPU
  devices of conftest.py, the leftover ranks data parallel), and every
  axis building its mesh for a given rank and refusing outside a joined
  world of enough ranks.
- Sharding rules: ``param_pspecs`` and ``kv_cache_pspecs`` equal JAX's
  leaf by leaf, as axis names, for dense, tied-head, ``attn_bias``,
  post-norm, MoE, int8 and int4 trees; and each rank's slice of a tree
  (``params_from_numpy_sharded``) equals, byte for byte, the shard JAX's
  ``shard_params`` puts on that rank's device of a tp 2 mesh.
- Joining a run: ``init_distributed`` forwards its arguments, raises on a
  real failure, is a no-op for its own world; the backend rule; a rank
  never moves to the CPU unasked; ``make_hybrid_mesh`` puts ``dp_dcn``
  outermost (mirroring tests/test_distributed.py).
- Model level: two gloo ranks (spawned processes, ``torch_tp_ranks``) run
  the port's ``prefill_into_cache`` and ``decode_step`` at tp 2 on JAX's
  weights; their logits are within 2e-4 of JAX's under a tp 2 mesh at
  fp32 (the tolerance of tests/test_parallel.py: the two differ in
  summation order only), for every tree form above.  At bf16 the two
  round at different places (and the port sums each row-parallel
  product's bf16 partials across ranks): the bound is
  tests/test_torch_transformer.py's, 2.5% of max |logit|.  It also holds
  the int8 and int4 trees: a quantized embedding gathers into bf16
  activations in both packages, so those forwards run at bf16.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_tunnel_tpu.models import quant as jq
from p2p_llm_tunnel_tpu.models import transformer as jt
from p2p_llm_tunnel_tpu.models.config import get_config as j_get_config
from p2p_llm_tunnel_tpu.parallel import best_mesh as j_best_mesh
from p2p_llm_tunnel_tpu.parallel import kv_cache_pspecs as j_kv_cache_pspecs
from p2p_llm_tunnel_tpu.parallel import make_mesh as j_make_mesh
from p2p_llm_tunnel_tpu.parallel import param_pspecs as j_param_pspecs
from p2p_llm_tunnel_tpu.parallel import shard_kv_cache as j_shard_kv_cache
from p2p_llm_tunnel_tpu.parallel import shard_params as j_shard_params
from p2p_llm_tunnel_tpu_torch.models import quant as tq
from p2p_llm_tunnel_tpu_torch.models import transformer as tt
from p2p_llm_tunnel_tpu_torch.models.config import get_config
from p2p_llm_tunnel_tpu_torch.parallel import distributed as pd
from p2p_llm_tunnel_tpu_torch.parallel import (
    best_mesh,
    kv_cache_pspecs,
    make_mesh,
    param_pspecs,
    shard_params,
)
from p2p_llm_tunnel_tpu_torch.parallel.mesh import AXES, best_tp
from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
    params_from_numpy_sharded,
    shard_kv_cache,
)

from torch_tp_ranks import run_ranks

FP32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_parallel.py
BF16_REL = 0.025  # tests/test_torch_transformer.py

#: tree form -> (preset, config overrides, weight dtype, weight quant).
FORMS = {
    "dense": ("tiny", dict(vocab_size=512), "float32", None),
    "tied-postnorm": ("tiny-gemma", dict(vocab_size=512), "float32", None),
    "attn-bias": ("tiny-qwen", dict(vocab_size=260), "float32", None),
    "moe": ("tiny-moe", dict(vocab_size=512), "float32", None),
    "int8": ("tiny", dict(vocab_size=512), "float32", "int8"),
    "int4": ("tiny", dict(vocab_size=512), "float32", "int4"),
    "bf16": ("tiny", dict(vocab_size=512), "bfloat16", None),
}
INT4_GROUP = 16  # whole groups in tiny's row-parallel K/2 = 32 and 64


def _jax_tree(form, seed=0):
    preset, over, dtype, quant = FORMS[form]
    jcfg = j_get_config(preset, **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    if quant == "int8":
        jp = jq.quantize_params(jp)
    elif quant == "int4":
        jp = jq.quantize_params_int4(jp, INT4_GROUP)
    return jcfg, jp


def _numpy(tree):
    """The JAX tree as numpy, quantized leaves as attribute namespaces (the
    bridge reads attributes; the spawned ranks cannot unpickle JAX's
    classes)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, jq.QTensor4):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale),
                                     in_dim=tree.in_dim, group_size=tree.group_size,
                                     axis=tree.axis)
    if isinstance(tree, jq.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def _spec_tree(tree):
    """Spec trees of both packages as comparable plain values."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if hasattr(tree, "group_size"):
        return ("int4", tuple(tree.q), tuple(tree.scale), int(tree.in_dim),
                int(tree.group_size), int(tree.axis))
    if hasattr(tree, "q"):
        return ("int8", tuple(tree.q), tuple(tree.scale))
    return tuple(tree)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_mesh_axes_and_rank_coordinates():
    mesh = make_mesh(tp=4, rank=6 % 4)
    assert mesh.axis_names == AXES == ("dp", "ep", "tp", "sp")
    assert mesh.shape == {"dp": 1, "ep": 1, "tp": 4, "sp": 1}
    assert (mesh.size, mesh.tp_rank) == (4, 2)
    # One process, no joined world: a tp mesh needs its ranks.
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(tp=2)
    assert make_mesh().tp == 1


@pytest.mark.parametrize("n_kv_heads", [1, 2, 4, 8, 16])
def test_best_tp_is_the_jax_rule(n_kv_heads, cpu_devices):
    jm = j_best_mesh(n_kv_heads=n_kv_heads)
    assert best_tp(n_kv_heads, len(cpu_devices)) == (jm.shape["tp"], jm.shape["dp"])


def test_best_mesh_makes_leftover_ranks_data_parallel():
    """Item 18d is ported: the leftover ranks are a dp axis, built like any
    mesh in a joined world of its ranks and refused outside one."""
    assert best_mesh(n_kv_heads=8, n_ranks=1).tp == 1
    assert best_tp(2, 8) == (2, 4)
    with pytest.raises(ValueError, match="mesh 4x1x2x1 needs 8 ranks, have 1"):
        best_mesh(n_kv_heads=2, n_ranks=8)  # tp 2, dp 4
    mesh = make_mesh(tp=2, dp=4, rank=5)
    assert (mesh.tp_rank, mesh.dp_rank, mesh.size) == (1, 2, 8)


@pytest.mark.parametrize("axis,item", [("sp", "18b"), ("ep", "18c"), ("dp", "18d")])
def test_sp_ep_dp_meshes_build_like_tp(axis, item):
    """Items 18b, 18c and 18d are ported: an sp, ep or dp mesh is built
    like a tp mesh, and outside a joined world of its ranks it is refused
    like one.  Rank 3 of a tp 2 x <axis> 2 mesh sits at 1 on both."""
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(**{axis: 2})
    mesh = make_mesh(tp=2, rank=3, **{axis: 2})
    assert (mesh.tp_rank, mesh.coord(axis), mesh.size) == (1, 1, 4)
    assert mesh.shape[axis] == 2


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", sorted(FORMS))
def test_param_pspecs_equal_jax(form):
    jcfg, jp = _jax_tree(form)
    preset, over, dtype, _ = FORMS[form]
    cfg = get_config(preset, **over)
    tp = tt.params_from_numpy(_numpy(jp), "cpu", getattr(torch, dtype))
    assert _spec_tree(param_pspecs(cfg, tp)) == _spec_tree(j_param_pspecs(jcfg, jp))
    assert _spec_tree(param_pspecs(cfg)) == _spec_tree(j_param_pspecs(jcfg))


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_kv_cache_pspecs_equal_jax(kv_quant):
    jcache = jt.init_kv_cache(j_get_config("tiny"), 3, 16, jnp.float32,
                              quant=kv_quant or False)
    cache = tt.init_kv_cache(get_config("tiny"), 3, 16, torch.float32,
                             quant=kv_quant, device="cpu")
    assert ({k: tuple(v) for k, v in kv_cache_pspecs(cache).items()}
            == {k: tuple(v) for k, v in j_kv_cache_pspecs(jcache).items()})
    assert kv_cache_pspecs() == {k: tuple(v) for k, v in j_kv_cache_pspecs().items()}


def _device_shard(arr, device):
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == device)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    elif hasattr(tree, "q"):
        yield path + ".q", tree.q
        yield path + ".scale", tree.scale
    else:
        yield path, tree


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_rank_shards_equal_jax_device_shards(form, rank, cpu_devices):
    """Rank r's slice of the tree equals what JAX's shard_params places on
    device r of a tp 2 mesh, leaf by leaf (quantized bytes and scales
    included); the same for the KV cache."""
    jcfg, jp = _jax_tree(form)
    preset, over, dtype, _ = FORMS[form]
    cfg = get_config(preset, **over)
    jmesh = j_make_mesh(tp=2)
    dev = jmesh.devices.reshape(-1)[rank]
    want = dict(_leaves(j_shard_params(jp, jcfg, jmesh)))
    got = dict(_leaves(params_from_numpy_sharded(
        _numpy(jp), cfg, make_mesh(tp=2, rank=rank), "cpu", getattr(torch, dtype))))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.float().numpy() if leaf.is_floating_point()
                                      else leaf.numpy(),
                                      _device_shard(want[path], dev).astype(
                                          np.float32 if leaf.is_floating_point()
                                          else np.int8), err_msg=path)
    jcache = j_shard_kv_cache(jt.init_kv_cache(jcfg, 3, 16, jnp.float32,
                                               quant="int8"), jmesh)
    cache = shard_kv_cache(tt.init_kv_cache(cfg, 3, 16, torch.float32,
                                            quant="int8", device="cpu"),
                           make_mesh(tp=2, rank=rank))
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == _device_shard(jcache[name], dev).shape


def test_shard_params_of_a_port_tree_matches_the_numpy_bridge():
    """``shard_params`` slices the port's own (kernel-laid-out) tree to the
    same shard the sharded bridge builds from numpy."""
    _, jp = _jax_tree("int4")
    cfg = get_config("tiny", vocab_size=512)
    full = tt.params_from_numpy(_numpy(jp), "cpu", torch.float32)
    for rank in (0, 1):
        mesh = make_mesh(tp=2, rank=rank)
        a = dict(_leaves(shard_params(full, cfg, mesh)))
        b = dict(_leaves(params_from_numpy_sharded(_numpy(jp), cfg, mesh, "cpu",
                                                   torch.float32)))
        for path in a:
            assert torch.equal(a[path], b[path]), path


def test_int4_row_parallel_shards_must_be_whole_groups():
    """tiny's ``wo`` contracts 64 positions: at tp 2 each rank's 32 are not
    a whole number of 128-position groups — refused with the shapes named
    (JAX's device_put refuses the same tree: its 1-group scale axis does
    not divide over tp)."""
    cfg = get_config("tiny", vocab_size=512)
    params = tq.quantize_params_int4(tt.init_params(cfg, 0, torch.float32, "cpu"), 128)
    with pytest.raises(ValueError, match=r"blocks\.wo.*K 64 cut on tp=2.*128-position groups"):
        shard_params(params, cfg, make_mesh(tp=2, rank=0))


def test_sharded_axes_must_divide():
    cfg = get_config("tiny", vocab_size=259)
    with pytest.raises(ValueError, match=r"embed \(259, 64\): axis 0 of size 259"):
        shard_params(tt.init_params(cfg, 0, torch.float32, "cpu"), cfg,
                     make_mesh(tp=2, rank=1))


def test_kernel7_fence_reads_the_shard_shapes():
    """``model_fence`` checks the row-parallel products at K/tp."""
    from p2p_llm_tunnel_tpu_torch.ops import quant_matmul as qm

    cfg = get_config("llama3-8b")
    assert qm.model_fence(cfg, "int4", 128, tp=2) is None
    # llama3-8b at tp 2: wo contracts 2048, w_down 7168 positions.
    plan = qm.launch_plan(17, 4096, 2048, "int4", "kn", 128)
    assert plan["nslabs"] * plan["bk"] >= 2048
    plan = qm.launch_plan(1, 64128, 4096, "int4", "kn", 128)
    assert plan["grid"][1] * plan["bn"] >= 64128


# ---------------------------------------------------------------------------
# model level: two gloo ranks against JAX's tp 2 mesh
# ---------------------------------------------------------------------------

def _case(form):
    preset, over, dtype, quant = FORMS[form]
    jcfg, jp = _jax_tree(form, seed=1)
    rng = np.random.default_rng(3)
    b, t = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, t)).astype(np.int32)
    return dict(preset=preset, overrides=over, dtype=dtype, params=_numpy(jp),
                slots=3, seq=32, tokens=tokens,
                lengths=np.array([16, 9], np.int32),
                slot_idx=np.array([1, 0], np.int32),
                dec_tokens=rng.integers(0, jcfg.vocab_size, size=(3,)).astype(np.int32),
                dec_pos=np.array([9, 16, 32], np.int32)), (jcfg, jp)


def _jax_logits(jcfg, jp, case, jmesh):
    cache = jt.init_kv_cache(jcfg, case["slots"], case["seq"], jnp.dtype(case["dtype"]))
    if jmesh is not None:
        jp = j_shard_params(jp, jcfg, jmesh)
        cache = j_shard_kv_cache(cache, jmesh)
    last, cache = jax.jit(lambda p, c: jt.prefill_into_cache(
        jcfg, p, jnp.asarray(case["tokens"]), jnp.asarray(case["lengths"]), c,
        jnp.asarray(case["slot_idx"])))(jp, cache)
    logits, _ = jax.jit(lambda p, c: jt.decode_step(
        jcfg, p, c, jnp.asarray(case["dec_tokens"]),
        jnp.asarray(case["dec_pos"])))(jp, cache)
    return np.asarray(last, np.float32), np.asarray(logits, np.float32)


@pytest.fixture(scope="module")
def tp2_logits(tmp_path_factory, cpu_devices):
    """Every form's case through the port's two ranks (one spawn for the
    module) and through JAX's tp 2 mesh."""
    cases, refs = {}, {}
    jmesh = j_make_mesh(tp=2)
    for form in FORMS:
        case, (jcfg, jp) = _case(form)
        cases[form] = case
        refs[form] = _jax_logits(jcfg, jp, case, jmesh)
    ranks = run_ranks("model_logits", 2, cases, tmp_path_factory.mktemp("tp2"))
    return ranks, refs


@pytest.mark.parametrize("form", sorted(FORMS))
def test_tp2_logits_match_jax_tp2_mesh(form, tp2_logits):
    ranks, refs = tp2_logits
    want_last, want_dec = refs[form]
    for rank in ranks:  # every rank holds the full-width logits
        got_last, got_dec = rank[form]
        # Row 2 of the decode step is parked past the cache: junk on both.
        for got, want in ((got_last, want_last), (got_dec[:2], want_dec[:2])):
            assert got.shape == want.shape
            if FORMS[form][2] == "float32" and FORMS[form][3] is None:
                np.testing.assert_allclose(got, want, **FP32_TOL)
            else:
                assert np.abs(got - want).max() < BF16_REL * np.abs(want).max()
    np.testing.assert_array_equal(ranks[0][form][0], ranks[1][form][0])
    np.testing.assert_array_equal(ranks[0][form][1], ranks[1][form][1])


# ---------------------------------------------------------------------------
# joining a run (parallel/distributed.py), mirroring tests/test_distributed.py
# ---------------------------------------------------------------------------

def test_hybrid_mesh_takes_dp_dcn_1_only():
    """``dp_dcn`` 1 is the flat mesh; ``dp_dcn`` 2 is the dp axis of the
    joined world (refused outside a world of its 4 ranks here)."""
    assert make_mesh() == pd.make_hybrid_mesh(tp=1, dp_dcn=1)
    with pytest.raises(ValueError, match="mesh 2x1x2x1 needs 4 ranks, have 1"):
        pd.make_hybrid_mesh(tp=2, dp_dcn=2)


def test_init_distributed_forwards_args(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    assert pd.init_distributed("host0:8476", 4, 1, device="cpu", timeout_s=30) == "gloo"
    assert (seen["backend"], seen["init_method"], seen["world_size"], seen["rank"],
            seen["timeout"].total_seconds()) == ("gloo", "tcp://host0:8476", 4, 1, 30)
    assert pd.run_timeout_s() == 30
    monkeypatch.setattr(pd, "_RUN", {"timeout_s": pd.DEFAULT_TIMEOUT_S})


def test_init_distributed_propagates_real_failures(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="refused"):
        pd.init_distributed("host0:8476", 4, 1, device="cpu")


def test_init_distributed_is_idempotent_for_its_own_world(monkeypatch):
    """A second join of the same world is a no-op (a router building
    several engines may call it); another world raises."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: pytest.fail("joined twice"))
    assert pd.init_distributed("host0:8476", 4, 1, device="cpu") == "gloo"
    with pytest.raises(RuntimeError, match="already joined as rank 1/4"):
        pd.init_distributed("host0:8476", 2, 0, device="cpu")


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 2, 2, "nccl"),  # a card a rank
    ("cuda", 2, 1, "gloo"),  # ranks share a card
    ("cuda", 8, 4, "gloo"),
])
def test_backend_rule(device, local, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pd.choose_backend(torch.device(device), local) == want


def test_a_rank_never_moves_to_the_cpu_unasked(monkeypatch):
    assert pd.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 1 has no CUDA device"):
        pd.rank_device(None, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.init_distributed("host0:8476", 2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pd.rank_device("cuda", 3) == torch.device("cuda", 1)


def test_init_method_forms():
    assert pd.init_method("host0:8476") == "tcp://host0:8476"
    assert pd.init_method("file:///tmp/x") == "file:///tmp/x"
    assert pd.local_rendezvous().startswith("localhost:")
