"""The rank mesh (port of p2p_llm_tunnel_tpu/parallel/mesh.py).

JAX's mesh is an array of devices that GSPMD partitions programs over.
The port runs one process per rank (``torch.distributed``), so its mesh is
a small value: the axis sizes, this rank's coordinates and the process
group of each axis that spans more than one rank.  The axes and their
order are the reference's, ``(dp, ep, tp, sp)`` with ``tp`` fastest: rank
``r``'s tp coordinate is ``r % tp``, so the tp ranks of one host are
neighbours.

Only ``tp`` may exceed 1 in this port so far; ``sp``, ``ep`` and ``dp``
raise ``NotPorted`` naming their ROADMAP.md items.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.models.transformer import NotPorted

AXES = ("dp", "ep", "tp", "sp")

#: Mesh axes the port does not shard over yet -> their ROADMAP.md items.
UNPORTED_AXES = {
    "sp": "18b, sequence parallelism (--sp, --sp-mode)",
    "ep": "18c, expert parallelism (--ep)",
    "dp": "18d, data parallelism across hosts (--dp-dcn > 1)",
}


@dataclass(frozen=True)
class Mesh:
    """Axis sizes, this rank's place on them and the tp process group.

    ``tp_group`` is the ``torch.distributed`` group the tensor-parallel
    collectives run over (None on a one-rank mesh, or on a mesh built only
    to slice weights for a given rank)."""

    tp: int = 1
    dp: int = 1
    sp: int = 1
    ep: int = 1
    rank: int = 0
    tp_group: Any = field(default=None, compare=False)

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


def _refuse_unported(**sizes: int) -> None:
    for axis, n in sizes.items():
        if n > 1:
            raise NotPorted(f"a mesh with {axis}={n}", UNPORTED_AXES[axis])


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1,
              rank: Optional[int] = None, tp_group=None) -> Mesh:
    """Mesh with axes ``(dp, ep, tp, sp)`` over ``dp*ep*tp*sp`` ranks.

    With ``rank`` None the mesh is this process's place in the joined
    ``torch.distributed`` world (``parallel/distributed.init_distributed``)
    and ``tp_group`` defaults to that world; a tp > 1 mesh outside a joined
    world of enough ranks raises.  An explicit ``rank`` builds the value
    without a world (slicing weights for that rank; no collective)."""
    for name, n in (("tp", tp), ("dp", dp), ("sp", sp), ("ep", ep)):
        if n < 1:
            raise ValueError(f"mesh axis {name} must be >= 1, got {n}")
    _refuse_unported(sp=sp, ep=ep, dp=dp)
    n = dp * ep * tp * sp
    if rank is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < n:
            raise ValueError(
                f"mesh {dp}x{ep}x{tp}x{sp} needs {n} ranks, have {world} "
                "(join them first: parallel.distributed.init_distributed)"
            )
        rank = dist.get_rank() if dist.is_initialized() else 0
        if tp > 1 and tp_group is None:
            tp_group = dist.group.WORLD
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is outside a mesh of {n} ranks")
    return Mesh(tp=tp, dp=dp, sp=sp, ep=ep, rank=rank, tp_group=tp_group)


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
