"""The rank mesh (port of p2p_llm_tunnel_tpu/parallel/mesh.py).

JAX's mesh is an array of devices that GSPMD partitions programs over.
The port runs one process per rank (``torch.distributed``), so its mesh is
a small value: the axis sizes, this rank's coordinates and the process
group of each axis that spans more than one rank.  The axes and their
layout are the reference's: axis names ``(dp, ep, tp, sp)``, ranks laid
out as ``(dp, ep, sp, tp)`` with ``tp`` fastest, so rank ``r``'s tp
coordinate is ``r % tp`` and its sp coordinate ``(r // tp) % sp`` — the tp
ranks of one host are neighbours.

``tp`` and ``sp`` may exceed 1; ``ep`` and ``dp`` raise ``NotPorted``
naming their ROADMAP.md items.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.models.transformer import NotPorted

AXES = ("dp", "ep", "tp", "sp")

#: Mesh axes the port does not shard over yet -> their ROADMAP.md items.
UNPORTED_AXES = {
    "ep": "18c, expert parallelism (--ep)",
    "dp": "18d, data parallelism across hosts (--dp-dcn > 1)",
}


@dataclass(frozen=True)
class Mesh:
    """Axis sizes, this rank's place on them and its process groups.

    ``tp_group`` is the ``torch.distributed`` group the tensor-parallel
    collectives run over (the ranks that share this rank's sp coordinate),
    ``sp_group`` the one the sequence-parallel exchanges run over (the
    ranks that share every coordinate but sp).  Both are None on a mesh
    built only to slice weights for a given rank."""

    tp: int = 1
    dp: int = 1
    sp: int = 1
    ep: int = 1
    rank: int = 0
    tp_group: Any = field(default=None, compare=False)
    sp_group: Any = field(default=None, compare=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "ep": self.ep, "tp": self.tp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.ep * self.tp * self.sp

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the tp axis (tp varies fastest)."""
        return self.rank % self.tp

    @property
    def sp_rank(self) -> int:
        """This rank's coordinate on the sp axis (next after tp)."""
        return (self.rank // self.tp) % self.sp


def _refuse_unported(**sizes: int) -> None:
    for axis, n in sizes.items():
        if n > 1:
            raise NotPorted(f"a mesh with {axis}={n}", UNPORTED_AXES[axis])


def _join_groups(tp: int, sp: int, rank: int):
    """This rank's (tp group, sp group) of the joined world: a tp group
    holds the ranks of one sp coordinate, an sp group the ranks of one tp
    coordinate.  An axis that spans the whole world is ``WORLD``; otherwise
    every rank creates every group of both axes, in the same order
    (``new_group`` is collective over the world: a rank that skipped one
    would hang the others)."""
    import torch.distributed as dist

    if tp == 1 or sp == 1:
        world = dist.group.WORLD
        return (world if tp > 1 else None), (world if sp > 1 else None)
    mine = {}
    for name, groups in (
            ("tp", [[s * tp + t for t in range(tp)] for s in range(sp)]),
            ("sp", [[s * tp + t for s in range(sp)] for t in range(tp)])):
        for ranks in groups:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[name] = group
    return mine["tp"], mine["sp"]


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1,
              rank: Optional[int] = None) -> Mesh:
    """Mesh with axes ``(dp, ep, tp, sp)`` over ``dp*ep*tp*sp`` ranks.

    With ``rank`` None the mesh is this process's place in the joined
    ``torch.distributed`` world (``parallel/distributed.init_distributed``),
    with its tp and sp groups; a mesh of more than one rank outside a
    joined world of enough ranks raises.  An explicit ``rank`` builds the
    value without a world (slicing weights for that rank; no collective)."""
    for name, n in (("tp", tp), ("dp", dp), ("sp", sp), ("ep", ep)):
        if n < 1:
            raise ValueError(f"mesh axis {name} must be >= 1, got {n}")
    _refuse_unported(ep=ep, dp=dp)
    n = dp * ep * tp * sp
    tp_group = sp_group = None
    joined = rank is None
    if joined:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < n:
            raise ValueError(
                f"mesh {dp}x{ep}x{tp}x{sp} needs {n} ranks, have {world} "
                "(join them first: parallel.distributed.init_distributed)"
            )
        rank = dist.get_rank() if dist.is_initialized() else 0
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is outside a mesh of {n} ranks")
    if joined and n > 1:
        tp_group, sp_group = _join_groups(tp, sp, rank)
    return Mesh(tp=tp, dp=dp, sp=sp, ep=ep, rank=rank, tp_group=tp_group,
                sp_group=sp_group)


def best_tp(n_kv_heads: int, n_ranks: int) -> Tuple[int, int]:
    """The reference's ``best_mesh`` rule as ``(tp, dp)``: tp is the largest
    power of two that divides both the rank count and ``n_kv_heads`` (so
    the KV cache shards cleanly); the ranks left over are data parallel."""
    tp = 1
    while (tp * 2 <= n_ranks and n_ranks % (tp * 2) == 0
           and n_kv_heads % (tp * 2) == 0):
        tp *= 2
    return tp, n_ranks // tp


def best_mesh(n_kv_heads: int, n_ranks: Optional[int] = None) -> Mesh:
    """Mesh of every rank of the joined world (``n_ranks``), tp capped by
    the kv-head count (``best_tp``); a leftover dp > 1 raises NotPorted."""
    if n_ranks is None:
        import torch.distributed as dist

        n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    tp, dp = best_tp(n_kv_heads, n_ranks)
    return make_mesh(tp=tp, dp=dp)
