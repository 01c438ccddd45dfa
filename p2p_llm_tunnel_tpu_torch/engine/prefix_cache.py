"""Automatic prefix caching: a device-side KV block pool + host block index
(port of p2p_llm_tunnel_tpu/engine/prefix_cache.py).

Prompt KV is saved in fixed-size blocks keyed by a chain hash of their
token content; a new request's longest cached prefix is COPIED into its
cache slot so prefill only computes the tail
(models/transformer.chunk_prefill_into_cache).  Copy, don't page: the
pool is a dense ``[L, P, B, K, D]`` tensor per cache leaf and matched
blocks are copied into the slot's contiguous cache region once at
admission, so decode stays unaware of the cache.

The host half (``PrefixIndex``, ``plan_group_admission``,
``plan_inserts``, ``pad_rows``, ``pad_ids``) is the reference's code with
numpy in place of ``jnp``; its operation sequences, evictions and plans
are identical (tests/test_torch_prefix_cache.py drives both with the same
random sequences).  The device half is plain tensor indexing: one batched
in-place indexed copy per ``prefill_rows``-wide sub-batch, pad rows going
to pool block 0 (never matched) or repeating a real row.  Quantized
caches pool every leaf, scale planes included; the packed int4 value
planes move in half-size byte pages.

Not ported yet (ROADMAP.md, port queue: spill tier, snapshots and
KV_PAGES): the host-RAM spill tier, pool snapshots and page pins.  The
engine refuses the knobs that would need them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class _Entry:
    """One pooled page's index record: pool slot, recompute-cost priority
    (GreedyDual, cost-aware mode), and the conversation tag (pages saved
    from a FINISHED stream's KV rather than a prompt insert)."""

    __slots__ = ("idx", "cost", "conv", "prio")

    def __init__(self, idx: int, cost: float = 0.0, conv: bool = False,
                 prio: float = 0.0):
        self.idx = idx
        self.cost = cost
        self.conv = conv
        self.prio = prio


class PrefixIndex:
    """Host-side chain-hash index: block content -> pool slot, with LRU or
    cost-aware (GreedyDual) eviction.

    A block's key is ``blake2b(parent_digest || block_token_bytes)``, so
    block i's key commits to the ENTIRE prefix ``[0, (i+1)*block)``; the
    digest is cryptographic so two prefixes cannot share a key by
    construction.  ``evict="cost"`` gives each page ``prio = clock +
    recompute_cost_ms`` refreshed on every touch; the victim is the
    minimum-priority page (LRU order breaks ties) and the clock rises to
    each victim's priority.  ``evict="lru"`` is plain least-recently-used.
    Pure host state, deterministic for a fixed operation sequence.
    """

    #: Bounded chain-key memo: one admitted prompt is hashed at up to three
    #: sites (reserve, match, missing) and herd prompts repeat.
    KEYS_MEMO_CAP = 128

    def __init__(self, block: int, capacity: int, evict: str = "lru"):
        assert capacity >= 2, "need at least scratch + one real block"
        if evict not in ("lru", "cost"):
            raise ValueError(f"unknown evict mode {evict!r}")
        self.block = block
        self.capacity = capacity
        self.evict = evict
        # Pool index 0 is the scratch block (insert-padding target).
        self._free: List[int] = list(range(1, capacity))
        self._lru: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._clock = 0.0
        self._keys_memo: "OrderedDict[tuple, List[bytes]]" = OrderedDict()
        self.hits = 0
        self.lookups = 0
        # Evictions + conversation-cache reuse (read by the engine's
        # delta-inc publisher) and the admission-time page reservation
        # tally (advisory; released grants must zero it — the leak gate).
        self.evictions = 0
        self.conv_hits = 0
        self.conv_hit_tokens = 0
        self.reserved_pages = 0
        # Keys evicted recently enough that re-allocating them means a
        # reuse distance past the pool's capacity (the thrash detector).
        self._recent_evicted: "OrderedDict[bytes, float]" = OrderedDict()
        self.thrash_reallocs = 0

    @property
    def used_blocks(self) -> int:
        """Pool blocks currently holding cached KV (excludes scratch)."""
        return len(self._lru)

    @property
    def free_blocks(self) -> int:
        """Pool blocks available for insertion without an eviction."""
        return len(self._free)

    def _keys_of(self, prompt_ids) -> List[bytes]:
        memo_key = tuple(prompt_ids)
        hit = self._keys_memo.get(memo_key)
        if hit is not None:
            self._keys_memo.move_to_end(memo_key)
            return hit
        keys = []
        h = b""
        b = self.block
        for i in range(len(prompt_ids) // b):
            window = np.asarray(prompt_ids[i * b : (i + 1) * b], np.int64)
            h = hashlib.blake2b(h + window.tobytes(), digest_size=16).digest()
            keys.append(h)
        self._keys_memo[memo_key] = keys
        if len(self._keys_memo) > self.KEYS_MEMO_CAP:
            self._keys_memo.popitem(last=False)
        return keys

    def match(self, prompt_ids) -> Tuple[int, List[int]]:
        """Longest cached prefix: (n_tokens, pool ids), possibly (0, []).

        Capped at ``(len(prompt)-1) // block`` blocks so at least one real
        token remains for the tail prefill (the first sampled token comes
        from the tail's last logits)."""
        self.lookups += 1
        max_blocks = (len(prompt_ids) - 1) // self.block
        ids: List[int] = []
        conv_blocks = 0
        for key in self._keys_of(prompt_ids)[:max_blocks]:
            entry = self._lru.get(key)
            if entry is None:
                break
            self._lru.move_to_end(key)  # touched = most recent
            entry.prio = self._clock + entry.cost
            if entry.conv:
                conv_blocks += 1
            ids.append(entry.idx)
        if ids:
            self.hits += 1
        if conv_blocks:
            # The match reached into pages saved from a finished stream.
            self.conv_hits += 1
            self.conv_hit_tokens += conv_blocks * self.block
        return len(ids) * self.block, ids

    def id_of(self, key: bytes) -> Optional[int]:
        """Current pool slot for ``key`` (no LRU touch), or None if evicted."""
        entry = self._lru.get(key)
        return None if entry is None else entry.idx

    def missing(self, prompt_ids) -> List[Tuple[int, bytes]]:
        """Fully-covered prompt blocks not yet pooled: [(block_no, key)]."""
        return [
            (i, key)
            for i, key in enumerate(self._keys_of(prompt_ids))
            if key not in self._lru
        ]

    def _pick_victim(self, protect: set) -> Optional[bytes]:
        """The next eviction victim, or None when every page is protected
        (allocated in the in-progress call).  "lru": the least-recently
        touched page; "cost": the minimum-priority page, LRU order breaking
        ties."""
        if self.evict == "lru":
            for key in self._lru:
                if key not in protect:
                    return key
            return None
        best_key, best_rank = None, None
        for pos, (key, entry) in enumerate(self._lru.items()):
            if key in protect:
                continue
            rank = (entry.prio, pos)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def _evict_one(self, protect: set) -> Optional[int]:
        """Evict one page (policy above); returns its freed pool idx."""
        victim = self._pick_victim(protect)
        if victim is None:
            return None
        entry = self._lru.pop(victim)
        # GreedyDual clock: the pool's value floor rises to each victim's
        # priority, so untouched expensive pages eventually age out.
        self._clock = max(self._clock, entry.prio)
        self.evictions += 1
        self._recent_evicted[victim] = self._clock
        while len(self._recent_evicted) > 4 * self.capacity:
            self._recent_evicted.popitem(last=False)
        return entry.idx

    def reserve(self, n: int) -> int:
        """Admission-time page reservation: make room for up to ``n`` pages
        NOW — evicting under the configured policy — and record the grant.
        The caller must :meth:`release` exactly the returned count."""
        grant = min(n, max(0, (self.capacity - 1) - self.reserved_pages))
        want = self.reserved_pages + grant
        while len(self._free) < want:
            idx = self._evict_one(set())
            if idx is None:
                break
            self._free.append(idx)
        self.reserved_pages += grant
        return grant

    def release(self, n: int) -> None:
        self.reserved_pages = max(0, self.reserved_pages - n)

    def allocate(self, keys: List[bytes], costs: Optional[List[float]] = None,
                 conv: bool = False) -> List[int]:
        """Assign a pool slot per key (evicting as needed); the caller must
        then copy the block content in.  ``costs`` (ms, one per key) feeds
        cost-aware eviction; ``conv`` tags conversation-cache pages.

        May return FEWER ids than keys: allocation stops rather than evict
        a key allocated in this same call, so a prefix of the requested
        blocks is still a matchable chain prefix."""
        out: List[int] = []
        newly: set = set()
        for j, key in enumerate(keys):
            if self._free:
                idx = self._free.pop()
            else:
                idx = self._evict_one(newly)
                if idx is None:
                    break  # pool exhausted by this very call: stop
            cost = costs[j] if costs is not None else 0.0
            if key in self._recent_evicted:
                del self._recent_evicted[key]
                self.thrash_reallocs += 1
            self._lru[key] = _Entry(idx, cost, conv, prio=self._clock + cost)
            newly.add(key)
            out.append(idx)
        return out


def plan_group_admission(
    index: PrefixIndex,
    inflight: Dict[bytes, int],
    wave: List[Tuple[int, List[int]]],
) -> Tuple[List[Tuple[int, int, List[int], List[bytes]]],
           List[Tuple[int, int]]]:
    """Prefix-aware batched admission planning: for a FIFO wave of
    ``[(rid, prompt_ids)]`` decide who PREFILLS and who WAITS, so a shared
    not-yet-pooled prefix is computed exactly once.  ``inflight`` (chain
    key -> owning rid) is updated in place.

    Returns ``(owners, waiters)``: owners ``[(rid, hist_tokens, pool_ids,
    missing_keys)]`` proceed now (their pooled prefix is copied in, the
    tail prefills, and the caller releases ``missing_keys`` when the
    prefill completes or the request dies); waiters ``[(rid, owner_rid)]``
    park because their FIRST missing block is already being computed by
    ``owner_rid`` — chain keys commit to the whole prefix, so sharing that
    key proves the waiter's uncached prefix is the owner's work.  FIFO
    within a group holds by construction.
    """
    owners: List[Tuple[int, int, List[int], List[bytes]]] = []
    waiters: List[Tuple[int, int]] = []
    for rid, prompt_ids in wave:
        hist, ids = index.match(prompt_ids)
        missing = index.missing(prompt_ids)
        if missing:
            owner = inflight.get(missing[0][1])
            if owner is not None and owner != rid:
                waiters.append((rid, owner))
                continue
        keys = [k for _, k in missing]
        for k in keys:
            # Released by the engine's _owner_done (finish or death).
            inflight[k] = rid
        owners.append((rid, hist, ids, keys))
    return owners, waiters


def plan_inserts(
    index: PrefixIndex, wave: List[Tuple[int, List[int]]],
    ms_per_token: float = 1.0, conv: bool = False,
) -> List[Tuple[int, List[int], List[int]]]:
    """Host-side planning for a batched pool insert: allocate blocks for
    every run's missing blocks, then drop pairs a later same-wave
    allocation evicted, so every surviving write is the content its key
    names and the ids are wave-distinct.  Page i costs its full-prefix
    token count ``(i+1) * block`` times ``ms_per_token``; ``conv`` tags
    conversation-cache pages.

    ``wave`` is [(slot, token_ids)]; returns [(slot, pool_ids, blk_nos)]
    ready for :func:`pad_rows`."""
    allocs: List[Tuple[int, List[bytes], List[int], List[int]]] = []
    for slot, prompt_ids in wave:
        missing = index.missing(prompt_ids)
        if not missing:
            continue
        keys = [k for _, k in missing]
        blk_nos = [i for i, _ in missing]
        costs = [(i + 1) * index.block * ms_per_token for i, _ in missing]
        ids = index.allocate(keys, costs=costs, conv=conv)
        if ids:
            allocs.append((slot, keys[: len(ids)], blk_nos[: len(ids)], ids))
    entries: List[Tuple[int, List[int], List[int]]] = []
    seen: set = set()
    for slot, keys, blks, ids in allocs:
        live = [
            (i, b)
            for k, b, i in zip(keys, blks, ids)
            if index.id_of(k) == i and i not in seen
        ]
        if live:
            seen.update(i for i, _ in live)
            entries.append((slot, [i for i, _ in live], [b for _, b in live]))
    return entries


def pad_rows(
    entries: List[Tuple[int, List[int], List[int]]],
    rows: int, max_blocks: int, scratch: Optional[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``[(slot, pool_ids, blk_nos)]`` to the fixed [R] / [R, Nmax]
    shapes of :func:`make_batch_copy_ops`: within a row per
    :func:`pad_ids`; missing rows repeat row 0 (cache <- pool: identical
    duplicate writes) or write scratch-only rows (pool <- cache)."""
    assert 0 < len(entries) <= rows
    slots: List[int] = []
    pids: List[List[int]] = []
    bnos: List[List[int]] = []
    for slot, ids, blks in entries:
        n = len(ids)
        assert 0 < n <= max_blocks and len(blks) == n
        pad = scratch if scratch is not None else ids[-1]
        slots.append(slot)
        pids.append(list(ids) + [pad] * (max_blocks - n))
        bnos.append(list(blks) + [blks[-1]] * (max_blocks - n))
    while len(slots) < rows:
        slots.append(slots[0])
        pids.append([scratch] * max_blocks if scratch is not None else pids[0])
        bnos.append(bnos[0])
    return (np.asarray(slots, np.int32), np.asarray(pids, np.int32),
            np.asarray(bnos, np.int32))


def pad_ids(
    ids: List[int], blk_nos: List[int], max_blocks: int, scratch: Optional[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (pool_ids, block_nos) to the fixed length: cache <- pool copies
    (``scratch is None``) repeat the last real pair, pool <- cache copies
    target the scratch pool block 0, which is never matched."""
    n = len(ids)
    assert 0 < n <= max_blocks
    pad = ids[-1] if scratch is None else scratch
    pids = list(ids) + [pad] * (max_blocks - n)
    bnos = list(blk_nos) + [blk_nos[-1]] * (max_blocks - n)
    return np.asarray(pids, np.int32), np.asarray(bnos, np.int32)


def pool_packed_keys(kv_cache: Dict[str, torch.Tensor]) -> frozenset:
    """The cache leaves whose sequence axis is BYTE-packed (two tokens per
    byte — the ``kv_quant="int4"`` value planes, recognized as
    ``transformer.kv_cache_quant_mode`` does).  Pages of these leaves are
    ``block // 2`` bytes; everything else (scales, raw and int8 planes) is
    ``block`` positions."""
    if ("k_scale" in kv_cache
            and kv_cache["k"].shape[2] * 2 == kv_cache["k_scale"].shape[2]):
        return frozenset({"k", "v"})
    return frozenset()


def init_pool(kv_cache: Dict[str, torch.Tensor], block: int,
              capacity: int) -> Dict[str, torch.Tensor]:
    """Pool tensors mirroring the cache's leaves, dtypes and device: cache
    ``[L, Slots, S, ...]`` -> pool ``[L, capacity, block, ...]``, scale
    planes included; packed int4 value leaves store ``block // 2`` BYTES
    per page (``block`` must be even under int4 — the page alignment the
    engine enforces)."""
    packed = pool_packed_keys(kv_cache)
    if packed and block % 2:
        raise ValueError(
            f"packed int4 pool pages must be even-sized, got block={block}"
        )
    return {
        key: torch.zeros(
            (arr.shape[0], capacity, block // 2 if key in packed else block)
            + tuple(arr.shape[3:]), dtype=arr.dtype, device=arr.device)
        for key, arr in kv_cache.items()
    }


def make_batch_copy_ops(block: int, max_blocks: int, rows: int,
                        packed_keys: frozenset = frozenset()):
    """The two row-batched copies: ONE indexed copy per leaf serves up to
    ``rows`` requests' blocks (per-request copies were the reference's
    measured TTFT regression).  Both update their first argument IN PLACE
    and return it; index arrays are the fixed [R] / [R, Nmax] shapes of
    :func:`pad_rows` (numpy or tensors).  ``packed_keys`` leaves (the int4
    value planes) move in ``block // 2``-byte page units — pages start on
    whole bytes by the page alignment, so packed copies are plain indexed
    copies too."""

    def _idx(x, device):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                               else x, device=device).to(torch.long)

    def _pos(key, blk_nos):  # [R, Nmax] -> [R, Nmax*unit] cache rows
        unit = block // 2 if key in packed_keys else block
        offs = torch.arange(unit, device=blk_nos.device)
        return (blk_nos[:, :, None] * unit + offs).reshape(rows, -1)

    def blocks_to_cache(cache, pool, slots, pool_ids, blk_nos):
        """cache[slots[r]] positions [blk_nos[r,i]*B, +B) <- pool[pool_ids[r,i]].
        Padding rows repeat a real row: duplicate writes carry identical
        bytes, so their order cannot matter."""
        dev = next(iter(cache.values())).device
        slots, pool_ids, blk_nos = (_idx(a, dev) for a in (slots, pool_ids, blk_nos))
        for key, arr in cache.items():
            pos = _pos(key, blk_nos)
            vals = pool[key][:, pool_ids]  # [L, R, Nmax, B, ...]
            flat = vals.reshape((vals.shape[0], rows, pos.shape[1])
                                + tuple(vals.shape[4:]))
            arr[:, slots[:, None], pos] = flat
        return cache

    def cache_to_pool(pool, cache, slots, pool_ids, blk_nos):
        """pool[pool_ids[r,i]] <- cache[slots[r]]; padding targets the
        scratch pool block 0.  Real pool ids must be wave-distinct
        (plan_inserts guarantees it)."""
        dev = next(iter(pool.values())).device
        slots, pool_ids, blk_nos = (_idx(a, dev) for a in (slots, pool_ids, blk_nos))
        flat_ids = pool_ids.reshape(-1)
        for key, arr in pool.items():
            pos = _pos(key, blk_nos)
            vals = cache[key][:, slots[:, None], pos]  # [L, R, Nmax*unit, ...]
            vals = vals.reshape((vals.shape[0], rows * max_blocks, arr.shape[2])
                                + tuple(vals.shape[3:]))
            arr[:, flat_ids] = vals
        return pool

    return blocks_to_cache, cache_to_pool
