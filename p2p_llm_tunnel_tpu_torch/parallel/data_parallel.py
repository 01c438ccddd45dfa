"""Data parallelism inside one engine: each dp rank serves its own slots
(the port's half of ROADMAP item 18d, ``--dp-dcn``).

The reference shards the KV cache's slot axis on ``dp``
(``kv_cache_pspecs``: ``[L, Slots, S, K, D]`` with ``Slots`` on dp), and
GSPMD partitions every program over it.  The port runs one process per
rank, so the partition is written out here:

- **Rows.**  The cache's ``rows`` (``num_slots`` plus the scratch slot)
  split into ``dp`` equal blocks; rank ``d`` holds rows ``[d*n, (d+1)*n)``
  and nothing else, so a rank's cache bytes are ``1/dp`` of dp 1's.  Where
  ``dp`` does not divide ``rows`` the engine refuses, as the reference's
  ``device_put`` of the cache does (a ``ValueError``; ``num_slots + 1``
  must divide over dp).
- **Decode steps and verify bursts** run on every rank over its own ``n``
  rows (its slice of the broadcast host inputs, its own decode carry and
  logit-bias rows); the sampled ids, counts and logprobs are gathered over
  ``dp_group`` (:func:`gather_rows`), so rank 0 reads every slot's.
  Seeded draws are a pure function of (seed, position), so which rank
  samples a row changes no draw.
- **Prefill, chunk and ragged waves** are routed row by row to the rank
  that owns the row's slot (:meth:`SlotShard.route`): each rank runs the
  wave's rows of its own slots, as a smaller wave, and the rows' first
  tokens and logprobs are combined over ``dp_group``
  (:meth:`SlotShard.combine`).  Routing, not computing the whole wave
  everywhere, because a chunk or ragged row attends to its slot's
  history, which only the owner holds; pad rows (the scratch slot) are
  dropped.  A rank with no row of a wave skips it, and so do the tp, sp
  and ep ranks it shares a dp coordinate with, so every collective inside
  the model stays matched.
- **The prefix pool is replicated** on every dp rank (the reference
  shards its blocks on dp): a pool page is written from the one rank that
  holds the source slot, summed bytewise over ``dp_group`` so every rank
  stores the same bytes (:func:`dp_copy_ops`), and read into a slot by
  the slot's owner alone.  Streams and pool contents are those of dp 1.

Every collective here is a byte-exact slot sum
(``parallel/collectives``), the one collective gloo runs on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.parallel import collectives
from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh


class SlotShard:
    """One dp rank's block of the engine's ``rows`` cache rows."""

    def __init__(self, mesh: Mesh, rows: int, scratch: int):
        if rows % mesh.dp:
            raise ValueError(
                f"the KV cache's slot axis of {rows} rows (num_slots "
                f"{rows - 1} + the scratch slot) does not divide over "
                f"dp={mesh.dp}: num_slots + 1 must be a multiple of dp"
            )
        self.dp = mesh.dp
        self.n = rows // mesh.dp
        self.lo = mesh.dp_rank * self.n
        self.hi = self.lo + self.n
        self.scratch = scratch
        self.group = mesh.dp_group

    def route(self, slots) -> np.ndarray:
        """Indices of the wave rows whose slot this rank owns (pad rows on
        the scratch slot excluded)."""
        s = np.asarray(slots)
        return np.nonzero((s >= self.lo) & (s < self.hi)
                          & (s != self.scratch))[0]

    def local(self, slots) -> np.ndarray:
        """Global slot ids of this rank's rows -> rows of its cache block."""
        return np.asarray(slots) - self.lo

    def rows(self, x):
        """This rank's rows of a host array over every cache row."""
        return x[self.lo:self.hi]

    def combine(self, part: Optional[torch.Tensor], idx: np.ndarray, nb: int,
                like: torch.Tensor) -> torch.Tensor:
        """The ``[nb, ...]`` result of a routed wave: this rank's rows
        ``idx`` (``part``, None when it ran none) in place, every other
        row from the rank that ran it.  ``like`` gives the row shape,
        dtype and device every rank agrees on."""
        full = like.new_zeros((nb,) + tuple(like.shape[1:]))
        if part is not None and len(idx):
            full[torch.as_tensor(idx, device=full.device)] = part
        return collectives._slot_sum(full.contiguous(), self.group)


def gather_rows(x: torch.Tensor, shard: SlotShard) -> torch.Tensor:
    """Every rank's ``[n, ...]`` block of ``x`` in rank order: ``[rows, ...]``."""
    return collectives.all_gather(x.contiguous(), 0, shard.group)


def dp_copy_ops(shard: SlotShard, blocks_to_cache, block: int,
                packed_keys: frozenset = frozenset()):
    """The prefix pool's two row-batched copies under dp, around the dp 1
    ``blocks_to_cache`` of ``prefix_cache.make_batch_copy_ops``: pool ->
    cache writes only this rank's slots (the pool is replicated); cache ->
    pool takes each real page (pool id != the scratch block 0) from the
    rank that holds its slot and writes it on every rank."""

    def copy_in(cache, pool, slots, pool_ids, blk_nos):
        own = shard.route(slots)
        if not len(own):
            return cache
        # Rows of other ranks' slots repeat an owned row: duplicate writes
        # carry identical bytes.
        pick = np.full(len(slots), own[0])
        pick[own] = own
        return blocks_to_cache(cache, pool, shard.local(np.asarray(slots)[pick]),
                               np.asarray(pool_ids)[pick],
                               np.asarray(blk_nos)[pick])

    def copy_out(pool, cache, slots, pool_ids, blk_nos):
        slots, pool_ids, blk_nos = (np.asarray(a) for a in (slots, pool_ids,
                                                             blk_nos))
        rows, cols = np.nonzero(pool_ids != 0)
        if not len(rows):
            return pool
        dev = next(iter(pool.values())).device
        mine = torch.as_tensor((slots[rows] >= shard.lo) & (slots[rows] < shard.hi),
                               device=dev)
        local = torch.as_tensor(np.clip(slots[rows] - shard.lo, 0, shard.n - 1),
                                device=dev, dtype=torch.long)
        ids = torch.as_tensor(pool_ids[rows, cols], device=dev, dtype=torch.long)
        blks = torch.as_tensor(blk_nos[rows, cols], device=dev, dtype=torch.long)
        for key, arr in pool.items():
            unit = block // 2 if key in packed_keys else block
            pos = blks[:, None] * unit + torch.arange(unit, device=dev)
            vals = cache[key][:, local[:, None], pos]  # [L, K, unit, ...]
            keep = mine.reshape((1, -1) + (1,) * (vals.dim() - 2))
            vals = torch.where(keep, vals, torch.zeros_like(vals)).contiguous()
            arr[:, ids] = collectives._slot_sum(vals, shard.group)
        return pool

    return copy_in, copy_out

