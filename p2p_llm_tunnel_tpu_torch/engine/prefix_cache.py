"""Automatic prefix caching: a device-side KV block pool + host block index
(port of p2p_llm_tunnel_tpu/engine/prefix_cache.py).

Prompt KV is saved in fixed-size blocks keyed by a chain hash of their
token content; a new request's longest cached prefix is COPIED into its
cache slot so prefill only computes the tail
(models/transformer.chunk_prefill_into_cache).  Copy, don't page: the
pool is a dense ``[L, P, B, K, D]`` tensor per cache leaf and matched
blocks are copied into the slot's contiguous cache region once at
admission, so decode stays unaware of the cache.

The host half (``PrefixIndex`` with its host-RAM spill tier,
``plan_group_admission``, ``plan_inserts``, ``pad_rows``, ``pad_ids``, the
page pin check and checksum) is the reference's code with numpy in place
of ``jnp``; its operation sequences, evictions and plans are identical
(tests/test_torch_prefix_cache.py and tests/test_torch_spill_tier.py drive
both with the same random sequences).  The device half is plain tensor
indexing: one batched in-place indexed copy per ``prefill_rows``-wide
sub-batch, pad rows going to pool block 0 (never matched) or repeating a
real row; ``page_out`` / ``page_in`` move one pool page between the card
and host RAM.  Quantized caches pool every leaf, scale planes included;
the packed int4 value planes move in half-size byte pages.

Tiered spill: cold pool pages are copied out to host RAM as byte payloads
with an integrity checksum and the pool's compatibility pins; an evicted
page with a host shadow MIGRATES to the tier instead of dying, and a
returning prompt whose chain continues into the tier is spliced back by a
two-phase page-in (claim a slot on the event loop, copy and verify on the
executor).  Correctness never depends on the tier: a failed or corrupt
page-in drops the page and the request re-prefills its tail.  Every page
that crosses a tier or tunnel boundary, and every snapshot, passes
:func:`verify_page_pin`.  Host copies of bf16 leaves are their 2-byte
``int16`` views (numpy has no bfloat16 of its own): the raw bytes, and so
:func:`page_checksum` and the snapshot files, are the reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


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


class PagePinError(ValueError):
    """A KV page's compatibility pins don't match the engine's (backend,
    seed, quant mode, group size, kv_quant, dtype, block geometry):
    splicing its bytes would silently serve KV computed under different
    numerics.  Callers treat the page as lost and fall back to tail
    re-prefill.  ``tunnel_code`` lets the serve layer mint the TYPED
    refusal when the mismatch crosses the tunnel (a KV_PAGES transfer)."""

    tunnel_code = "page_pin"


def verify_page_pin(page, meta: Dict, want: Dict):
    """THE registered tier-boundary check (tunnelcheck TC18/TC20): every
    KV page crossing a tier or tunnel boundary flows through here before
    its bytes are spliced into a pool or sent.  Returns ``page`` only when
    every pin in ``want`` matches the page's recorded ``meta``."""
    for key, val in want.items():
        if meta.get(key) != val:
            raise PagePinError(
                f"KV page pin mismatch on {key!r}: page carries "
                f"{meta.get(key)!r}, engine wants {val!r}"
            )
    return page


def page_checksum(payload: Dict[str, np.ndarray]) -> bytes:
    """Integrity digest over a host-tier page's raw bytes, leaf-name keyed
    so a leaf swap can't cancel out.  Verified on every page-in."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(payload):
        h.update(key.encode())
        h.update(np.ascontiguousarray(payload[key]).tobytes())
    return h.digest()


class _SpillPage:
    """One host-RAM tier page: the paged-out pool bytes (a dict of
    per-leaf numpy arrays), their checksum, the compatibility pins that
    ride every page across a tier boundary, and the GreedyDual accounting
    carried over from the pool entry."""

    __slots__ = ("payload", "checksum", "meta", "cost", "conv", "prio")

    def __init__(self, payload: Dict[str, np.ndarray], checksum: bytes,
                 meta: Dict, cost: float = 0.0, conv: bool = False,
                 prio: float = 0.0):
        self.payload = payload
        self.checksum = checksum
        self.meta = meta
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

    def __init__(self, block: int, capacity: int, evict: str = "lru",
                 spill_pages: int = 0):
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
        # Host-RAM spill tier: shadows of pool pages by chain key.  While
        # the key is also pool-resident the shadow is a pre-paid copy
        # (eviction then migrates instead of destroying); once evicted it
        # is the page's only body.  Event-loop thread only: the executor
        # copies bytes, the loop commits them.
        self.spill_pages = max(0, int(spill_pages))
        self._spill: "OrderedDict[bytes, _SpillPage]" = OrderedDict()
        self.spill_pageouts = 0
        self.spill_pageins = 0
        self.spill_drops = 0
        # Pages spliced from the WIRE (a prefill peer's KV_PAGES transfer):
        # the same two-phase path, counted apart from the spill tier.
        self.wire_spliced = 0
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

    @property
    def spill_resident(self) -> int:
        """Host-tier pages currently held (shadows + host-only)."""
        return len(self._spill)

    def export_state(self) -> List[List]:
        """Snapshot rows: a leading ``["clock", value]`` row (the
        GreedyDual value floor), then LRU-ordered ``[hex key, pool idx,
        cost, conv, prio]`` for pool-resident pages, then ``[hex key, -1,
        ...]`` markers for host-only spilled pages — their bytes live in
        process RAM, which the snapshot file does not carry."""
        rows: List[List] = [["clock", round(self._clock, 3)]]
        rows += [
            [k.hex(), e.idx, round(e.cost, 3), int(e.conv), round(e.prio, 3)]
            for k, e in self._lru.items()
        ]
        rows += [
            [k.hex(), -1, round(p.cost, 3), int(p.conv), round(p.prio, 3)]
            for k, p in self._spill.items()
            if k not in self._lru
        ]
        return rows

    def import_state(self, entries: List[List]) -> None:
        """Restore a snapshot's index; unreferenced pool slots become free.
        Malformed entries are skipped (a damaged manifest degrades to a
        partly cold pool, never a crash); the 2-, 4- and 5-field row
        shapes are accepted.  Spilled-page markers (idx -1), out-of-range
        and duplicate indices are skipped: admitting them would alias two
        prefix keys to one KV block."""
        self._lru.clear()
        self._clock = 0.0
        used = set()
        for entry in entries:
            try:
                if entry[0] == "clock":
                    self._clock = float(entry[1])
                    continue
                khex, idx = entry[0], int(entry[1])
                key = bytes.fromhex(khex)
                cost = float(entry[2]) if len(entry) > 2 else 0.0
                conv = bool(entry[3]) if len(entry) > 3 else False
                prio = float(entry[4]) if len(entry) > 4 else cost
            except (TypeError, ValueError, IndexError):
                continue
            if not 1 <= idx < self.capacity or idx in used:
                continue
            self._lru[key] = _Entry(idx, cost, conv, prio=prio)
            used.add(idx)
        self._free = [i for i in range(1, self.capacity) if i not in used]

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
        ties.  With the spill tier both are CLEAN-FIRST: a page with a host
        shadow is recoverable, so dirty pages go only when no clean one
        is left."""
        clean_tier = self.spill_pages > 0
        if self.evict == "lru":
            dirty_fallback = None
            for key in self._lru:
                if key in protect:
                    continue
                if clean_tier and key not in self._spill:
                    if dirty_fallback is None:
                        dirty_fallback = key
                    continue
                return key
            return dirty_fallback
        best_key, best_rank = None, None
        for pos, (key, entry) in enumerate(self._lru.items()):
            if key in protect:
                continue
            dirty = 1 if (clean_tier and key not in self._spill) else 0
            rank = (dirty, entry.prio, pos)
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
        page = self._spill.get(victim)
        if page is not None:
            # Tier migration, not loss: the host shadow becomes the page's
            # only body and keeps the entry's accounting.
            page.cost, page.conv, page.prio = entry.cost, entry.conv, entry.prio
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
            if key in self._spill:
                # Fresh bytes under a spilled key supersede the shadow:
                # splicing the stale shadow later would break identity.
                self._spill.pop(key)
                self.spill_drops += 1
            self._lru[key] = _Entry(idx, cost, conv, prio=self._clock + cost)
            newly.add(key)
            out.append(idx)
        return out

    # -- host-RAM spill tier: event-loop bookkeeping; the engine plans here,
    # copies bytes on its executor, and commits back here.

    def spill_plan(self, n: int,
                   exclude: frozenset = frozenset()) -> List[Tuple[bytes, int]]:
        """The ``n`` lowest-priority pool-resident pages with no host
        shadow yet, [(key, pool idx)], in (prio, LRU position) order;
        ``exclude`` protects pages about to be matched."""
        if n <= 0 or self.spill_pages <= 0:
            return []
        cands = [
            (entry.prio, pos, key, entry.idx)
            for pos, (key, entry) in enumerate(self._lru.items())
            if key not in self._spill and key not in exclude
        ]
        cands.sort()
        return [(key, idx) for _, _, key, idx in cands[:n]]

    def note_spilled(self, key: bytes, payload: Dict[str, np.ndarray],
                     checksum: bytes, meta: Dict) -> bool:
        """Commit one completed page-out.  Rejected when the page was
        evicted mid-copy (its slot may be recycled) or already shadowed;
        makes room when the tier is full."""
        entry = self._lru.get(key)
        if entry is None or key in self._spill:
            return False
        self._spill_make_room()
        self._spill[key] = _SpillPage(payload, checksum, meta,
                                      entry.cost, entry.conv, entry.prio)
        self.spill_pageouts += 1
        return True

    def _spill_make_room(self) -> None:
        """Cap the tier at ``spill_pages``: drop shadows of still-resident
        pages first (nothing is lost), then the lowest-priority host-only
        page."""
        while len(self._spill) >= max(1, self.spill_pages):
            best_key, best_rank = None, None
            for pos, (key, page) in enumerate(self._spill.items()):
                rank = (0 if key in self._lru else 1, page.prio, pos)
                if best_rank is None or rank < best_rank:
                    best_key, best_rank = key, rank
            self._spill.pop(best_key)
            self.spill_drops += 1

    def spill_extension(self, prompt_ids) -> List[Tuple[int, bytes]]:
        """Host-tier pages that would EXTEND this prompt's pool match:
        [(block_no, key)] of host-only chain keys past the resident
        prefix, skipping resident keys, stopping at the first key in
        neither tier; capped like :meth:`match`."""
        if not self._spill:
            return []
        max_blocks = (len(prompt_ids) - 1) // self.block
        keys = self._keys_of(prompt_ids)[:max_blocks]
        i = 0
        while i < len(keys) and keys[i] in self._lru:
            i += 1
        out: List[Tuple[int, bytes]] = []
        for j in range(i, len(keys)):
            key = keys[j]
            if key in self._lru:
                continue
            if key in self._spill:
                out.append((j, key))
            else:
                break
        return out

    def chain_keys(self, prompt_ids) -> List[bytes]:
        """ALL of the prompt's matchable chain keys (no LRU touch): the
        protection set a page-in claim must honor, mid-chain residents
        past a gap included."""
        max_blocks = (len(prompt_ids) - 1) // self.block
        return list(self._keys_of(prompt_ids)[:max_blocks])

    def touch_resident(self, keys) -> None:
        """MRU-touch the resident members of a page-in wave's protection
        set, so admission's own evictions later in the iteration take
        genuinely cold pages first."""
        for key in keys:
            if key in self._lru:
                self._lru.move_to_end(key)

    def page_in_alloc(self, keys: List[bytes],
                      protect: frozenset = frozenset(),
                      offered: "Optional[Dict[bytes, _SpillPage]]" = None,
                      ) -> List[Tuple[bytes, int, "_SpillPage"]]:
        """Two-phase page-in, phase 1: claim one pool slot per host-tier
        key (evicting under the policy, never a ``protect`` key) WITHOUT
        touching the index; the caller finishes every claim with
        :meth:`commit_page_in` or :meth:`abort_page_in`.  ``offered``
        sources pages from a caller's map (a KV_PAGES transfer) instead
        of the tier."""
        out: List[Tuple[bytes, int, _SpillPage]] = []
        prot = set(protect)
        for key in keys:
            page = (self._spill.get(key) if offered is None
                    else offered.get(key))
            if page is None or key in self._lru:
                continue
            if self._free:
                idx = self._free.pop()
            else:
                idx = self._evict_one(prot)
                if idx is None:
                    break
            out.append((key, idx, page))
        return out

    def commit_page_in(self, key: bytes, idx: int,
                       page: "Optional[_SpillPage]" = None) -> None:
        """Phase 2 success: the verified bytes are in pool slot ``idx``.
        The shadow stays (it still matches the pool copy).  ``page``
        carries a wire page's accounting; wire splices count apart."""
        from_tier = page is None
        if from_tier:
            page = self._spill.get(key)
        cost = page.cost if page is not None else 0.0
        conv = page.conv if page is not None else False
        self._lru[key] = _Entry(idx, cost, conv, prio=self._clock + cost)
        if from_tier:
            self.spill_pageins += 1
        else:
            self.wire_spliced += 1

    def abort_page_in(self, key: bytes, idx: int) -> None:
        """Phase 2 failure (chaos, checksum or pin mismatch): return the
        slot and DROP the host page — the request re-prefills its tail."""
        if self._spill.pop(key, None) is not None:
            self.spill_drops += 1
        self._free.append(idx)


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


def host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of ``t``'s host copy: bf16 travels as its 2-byte
    ``int16`` view."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy COPY of ``t`` (never a view of a CPU pool), bf16 as
    its ``int16`` view.  From the card the copy is synchronous, so it
    reads after every write the stream queued before it."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def to_device(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (a host copy from :func:`to_host` or the wire) as a tensor of
    ``like``'s dtype on ``like``'s device."""
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def wire_dtype_name(t: torch.Tensor) -> str:
    """A leaf's dtype string on the wire: the reference's numpy names
    (``"bfloat16"``, ``"int8"``, ``"float32"``)."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host_dtype(t))


def page_out(pool: Dict[str, torch.Tensor], idx: int) -> Dict[str, np.ndarray]:
    """One pool page's leaves, ``{leaf: pool[leaf][:, idx]}``, copied to
    host RAM (packed int4 value leaves are ``block // 2`` bytes a page)."""
    return {key: to_host(arr[:, idx]) for key, arr in pool.items()}


def page_in(pool: Dict[str, torch.Tensor], idx: int,
            page: Dict[str, np.ndarray]) -> None:
    """Write a verified host page into pool slot ``idx`` in place: the
    whole slot and nothing else."""
    for key, arr in pool.items():
        arr[:, idx].copy_(to_device(page[key], arr))


def save_pool_snapshot(
    dirpath: str, pool: Dict[str, torch.Tensor], index: PrefixIndex,
    meta: Dict,
) -> None:
    """Persist the block pool + index so warm prompt KV survives a serve
    restart: ``prefix_pool.npz`` (the pool leaves, bf16 as ``int16``
    views, and the snapshot id) and ``prefix_index.json`` (version 3: the
    pins in ``meta``, the index rows, the snapshot id and the pool's
    :func:`page_checksum`).  Each file is written to a temporary name and
    renamed; the shared snapshot id pairs the halves, so a crash between
    the renames cannot pair new pool bytes with an old index."""
    os.makedirs(dirpath, exist_ok=True)
    snap_id = f"{time.time_ns():x}"
    host_pool = {k: to_host(v) for k, v in pool.items()}
    npz_tmp = os.path.join(dirpath, ".prefix_pool.npz.tmp")
    with open(npz_tmp, "wb") as f:
        np.savez(
            f,
            __snap_id__=np.frombuffer(snap_id.encode(), np.uint8),
            **host_pool,
        )
    os.replace(npz_tmp, os.path.join(dirpath, "prefix_pool.npz"))
    manifest = dict(meta, lru=index.export_state(), version=3,
                    snap_id=snap_id,
                    pool_checksum=page_checksum(host_pool).hex())
    man_tmp = os.path.join(dirpath, ".prefix_index.json.tmp")
    with open(man_tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(man_tmp, os.path.join(dirpath, "prefix_index.json"))
    log.info("prefix pool snapshot saved: %d blocks -> %s",
             len(index._lru), dirpath)


def load_pool_snapshot(
    dirpath: str, pool: Dict[str, torch.Tensor], index: PrefixIndex,
    meta: Dict,
) -> Optional[Dict[str, torch.Tensor]]:
    """Restore a snapshot into new pool tensors shaped like ``pool`` (on
    its device); None, with the index untouched, when the files are
    absent or unreadable, the manifest is not version 3, a pin differs,
    the halves come from different saves, the leaf set, a shape or a
    dtype differs, or the pool bytes fail their checksum."""
    man_path = os.path.join(dirpath, "prefix_index.json")
    npz_path = os.path.join(dirpath, "prefix_pool.npz")
    if not (os.path.exists(man_path) and os.path.exists(npz_path)):
        return None
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        log.warning("prefix snapshot unreadable (%s); starting cold", e)
        return None
    if manifest.get("version") != 3:
        log.warning("prefix snapshot version %r unsupported (current: 3); "
                    "starting cold", manifest.get("version"))
        return None
    try:
        verify_page_pin(None, manifest, meta)
    except PagePinError as e:
        log.warning("prefix snapshot incompatible (%s); starting cold", e)
        return None
    try:
        npz = np.load(npz_path)
    except Exception as e:  # BadZipFile/OSError/EOFError: a corrupt file
        log.warning("prefix snapshot unreadable (%s); starting cold", e)
        return None
    with npz:
        try:
            files = set(npz.files)
            snap_id = bytes(npz["__snap_id__"]).decode()
        except Exception as e:  # a corrupt zip member surfaces on read
            log.warning("prefix snapshot unreadable (%s); starting cold", e)
            return None
        if snap_id != manifest.get("snap_id"):
            log.warning("prefix snapshot halves mismatch (%s != %s); "
                        "starting cold", snap_id, manifest.get("snap_id"))
            return None
        if files - {"__snap_id__"} != set(pool):
            log.warning("prefix snapshot leaves mismatch; starting cold")
            return None
        host = {}
        for key, arr in pool.items():
            try:
                loaded = npz[key]
            except Exception as e:
                log.warning("prefix snapshot unreadable (%s); starting cold", e)
                return None
            if loaded.shape != tuple(arr.shape) or loaded.dtype != host_dtype(arr):
                log.warning("prefix snapshot shape mismatch on %s; starting "
                            "cold", key)
                return None
            host[key] = loaded
    got = page_checksum(host).hex()
    if got != manifest.get("pool_checksum"):
        log.warning("prefix snapshot pool checksum mismatch (%s != %s); "
                    "starting cold", got, manifest.get("pool_checksum"))
        return None
    out = {key: to_device(host[key], arr) for key, arr in pool.items()}
    index.import_state(manifest.get("lru", []))
    log.info("prefix pool snapshot restored: %d blocks from %s",
             len(index._lru), dirpath)
    return out
