"""The rank mesh (port of p2p_llm_tunnel_tpu/parallel/mesh.py).

JAX's mesh is an array of devices that GSPMD partitions programs over.
The port runs one process per rank (``torch.distributed``), so its mesh is
a small value: the axis sizes, this rank's coordinates and the process
group of each axis that spans more than one rank.  The axes and their
layout are the reference's: axis names ``(dp, ep, tp, sp)``, ranks laid
out as ``(dp, ep, sp, tp)`` with ``tp`` fastest, so rank ``r``'s tp
coordinate is ``r % tp``, its sp coordinate ``(r // tp) % sp``, its ep
coordinate ``(r // (tp * sp)) % ep`` and its dp coordinate
``r // (tp * sp * ep)`` — the tp ranks of one host are neighbours and dp
is outermost (across hosts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

AXES = ("dp", "ep", "tp", "sp")

#: The rank layout, slowest axis first (JAX's ``reshape(dp, ep, sp, tp)``).
LAYOUT = ("dp", "ep", "sp", "tp")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes, this rank's place on them and its process groups.

    Each ``<axis>_group`` is the ``torch.distributed`` group of the ranks
    that share every coordinate but that axis: ``tp_group`` carries the
    tensor-parallel collectives, ``sp_group`` the sequence-parallel
    exchanges, ``ep_group`` the expert-parallel sum of the MoE block and
    ``dp_group`` the gather of each rank's sampled rows.  A group is None
    where its axis has size 1, and every group is None on a mesh built
    only to slice weights for a given rank."""

    tp: int = 1
    dp: int = 1
    sp: int = 1
    ep: int = 1
    rank: int = 0
    tp_group: Any = field(default=None, compare=False)
    sp_group: Any = field(default=None, compare=False)
    ep_group: Any = field(default=None, compare=False)
    dp_group: Any = field(default=None, compare=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "ep": self.ep, "tp": self.tp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.ep * self.tp * self.sp

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return coords(self.shape, self.rank)[axis]

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the tp axis (tp varies fastest)."""
        return self.coord("tp")

    @property
    def sp_rank(self) -> int:
        """This rank's coordinate on the sp axis (next after tp)."""
        return self.coord("sp")

    @property
    def ep_rank(self) -> int:
        """This rank's coordinate on the ep axis (next after sp)."""
        return self.coord("ep")

    @property
    def dp_rank(self) -> int:
        """This rank's coordinate on the dp axis (outermost)."""
        return self.coord("dp")


def coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis of a mesh of ``shape``."""
    out = {}
    for axis in reversed(LAYOUT):
        out[axis] = rank % shape[axis]
        rank //= shape[axis]
    return out


def axis_groups(shape: Dict[str, int], axis: str):
    """Every group of ``axis``: the lists of ranks that share every other
    coordinate, each in ``axis`` order, in a fixed order."""
    n = 1
    for a in AXES:
        n *= shape[a]
    groups: Dict[Tuple[int, ...], list] = {}
    for r in range(n):
        c = coords(shape, r)
        groups.setdefault(tuple(c[a] for a in LAYOUT if a != axis), []).append(r)
    return [groups[k] for k in sorted(groups)]


def _join_groups(shape: Dict[str, int], rank: int) -> Dict[str, Any]:
    """This rank's group of each axis of the joined world (None where the
    axis has size 1).  An axis that spans the whole world is ``WORLD``;
    otherwise every rank creates every group of every axis, in one fixed
    order (``new_group`` is collective over the world: a rank that skipped
    one would hang the others)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    mine: Dict[str, Any] = {}
    for axis in ("tp", "sp", "ep", "dp"):
        if shape[axis] == 1:
            mine[axis] = None
        elif shape[axis] == world:
            mine[axis] = dist.group.WORLD
        else:
            for ranks in axis_groups(shape, axis):
                group = dist.new_group(ranks)
                if rank in ranks:
                    mine[axis] = group
    return mine


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1,
              rank: Optional[int] = None) -> Mesh:
    """Mesh with axes ``(dp, ep, tp, sp)`` over ``dp*ep*tp*sp`` ranks.

    With ``rank`` None the mesh is this process's place in the joined
    ``torch.distributed`` world (``parallel/distributed.init_distributed``),
    with its group of each axis; a mesh of more than one rank outside a
    joined world of enough ranks raises.  An explicit ``rank`` builds the
    value without a world (slicing weights for that rank; no collective)."""
    shape = {"dp": dp, "ep": ep, "tp": tp, "sp": sp}
    for name, n in shape.items():
        if n < 1:
            raise ValueError(f"mesh axis {name} must be >= 1, got {n}")
    n = dp * ep * tp * sp
    groups: Dict[str, Any] = {}
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
        groups = _join_groups(shape, rank)
    return Mesh(tp=tp, dp=dp, sp=sp, ep=ep, rank=rank,
                **{f"{a}_group": g for a, g in groups.items()})


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
    the kv-head count (``best_tp``), the ranks left over data parallel."""
    if n_ranks is None:
        import torch.distributed as dist

        n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    tp, dp = best_tp(n_kv_heads, n_ranks)
    return make_mesh(tp=tp, dp=dp)
