"""The exchanges sequence parallelism runs over a mesh's sp group: the
one-hop ring shift (the reference's ``jax.lax.ppermute``), the tiled
sequence <-> head swap (``jax.lax.all_to_all(..., tiled=True)``) and the
sequence gather (the all-gather GSPMD inserts where a sequence-sharded
array meets a replicated one); tp's logits gather is the sequence gather
over the tp group.

Each exchange is one ``all_reduce`` of a zeroed buffer with a slot per
rank, each rank writing only its own slots.  That is the one collective
every backend takes on every device: gloo has no send/recv, all_to_all or
all_gather on CUDA tensors (ranks that share a card, where NCCL refuses
two ranks on one GPU).  ``chip_smoke.py --sp-nccl`` times each exchange
against NCCL's own collective for it (PERF.md).  The buffer is summed as
bytes (``uint8``), so every slot arrives bit for bit: one rank adds its
bytes to zeros (a float sum would turn ``-0.0`` into ``0.0``).
A failed collective raises.  ``exchanges`` counts the calls by exchange.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

#: Calls since the last ``clear()``, by exchange.
exchanges: Counter = Counter()


def _setup(name: str, group):
    """(group size, this rank's place in the group); counts the call."""
    exchanges[name] += 1
    return dist.get_world_size(group), dist.get_rank(group)


def _slot_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """All-reduce ``buf`` (contiguous; each slot written by one rank, zeros
    elsewhere) as bytes, IN PLACE: every slot arrives exactly."""
    dist.all_reduce(buf.view(torch.uint8), group=group)
    return buf


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` one hop around the ring (group rank i to i + 1 mod n) and
    return the block rank i - 1 sent."""
    n, r = _setup("ring_shift", group)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[(r + 1) % n] = x
    return _slot_sum(buf, group)[r]


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into n equal pieces along ``split_axis``,
    piece j to group rank j; the pieces received, in rank order,
    concatenated along ``concat_axis``."""
    n, r = _setup("all_to_all", group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.tensor_split(n, dim=split_axis))  # [n, ...] piece per peer
    buf = send.new_zeros((n,) + tuple(send.shape))  # [from, to, ...]
    buf[r] = send
    recv = _slot_sum(buf, group)[:, r]
    return torch.cat(recv.unbind(0), dim=concat_axis)


def all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every group rank's ``x``, concatenated in rank order along ``axis``."""
    n, r = _setup("all_gather", group)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[r] = x
    _slot_sum(out, group)
    return torch.cat(out.unbind(0), dim=axis)
