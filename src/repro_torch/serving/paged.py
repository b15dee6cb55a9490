"""Paged KV cache bookkeeping: block pool, prefix cache, block tables.

The dense per-slot cache sizes KV memory as ``slots x max_len`` whether
or not the slots are full.  Paging replaces it with a global pool of
fixed-size blocks (vLLM-style): each slot owns a *block table* mapping
logical block index -> physical pool block, blocks are refcounted, and
identical prompt prefixes resolve to the SAME physical blocks through a
hash-of-prefix cache — admission then skips prefill for the shared
portion and only computes the divergent suffix.

This module is pure host-side bookkeeping (numpy + python): it decides
WHICH physical block every position lives in; the device-side pool
arrays live in the engine's cache pytree and are indexed by the block
tables this module maintains (``models.attention`` scatter/gather and
the block-table-indexed Pallas kernel in ``kernels.decode_attention``).

Block lifecycle / refcount semantics:
  - ``alloc()`` hands a free block to one slot (refcount 1).
  - attaching a cached block to another slot increfs it.
  - registering a full prompt block in the prefix cache increfs it once
    (the cache's own hold), so the block outlives its slot.
  - ``release(slot)`` decrefs every block the slot holds; blocks whose
    only remaining hold is the prefix cache stay resident (hit-able)
    until LRU eviction recycles them under allocation pressure.

Copy-on-write: writes may only touch blocks with refcount 1.  When the
divergence point of a prefix hit falls INSIDE a shared block (a fully
cached prompt re-computes its last position), the shared block is copied
into a fresh one at admission and the slot's table is repointed — the
classic COW-at-the-divergence-block move, surfaced to the engine as a
(src, dst) device-copy list.

The last physical block of the pool is a write dump ("trash" block):
unattached block-table entries point at it, so batched forwards that
write junk rows (inactive slots, bucket padding) land somewhere harmless
instead of corrupting live blocks.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.granularity import cdiv

__all__ = ["PagedKVConfig", "BlockAllocator", "PrefixCache", "BlockManager",
           "AdmitResult"]


@dataclass(frozen=True)
class PagedKVConfig:
    """Paged-cache knobs (``launch.serve --kv-block-size / --kv-blocks``).

    ``block_size`` is the paging granularity in positions — with the
    Pallas path it is also the kernel's kv tile (the k_block), which is
    how paging enters the NFP granularity accounting.  ``n_blocks`` is
    the pool size in blocks (default: enough for ``batch`` dense slots,
    i.e. memory parity with the dense cache; smaller pools trade
    capacity for admission backpressure).  ``prefix_cache`` toggles
    hash-of-prefix block reuse.
    """

    block_size: int = 128
    n_blocks: Optional[int] = None
    prefix_cache: bool = True


@dataclass
class AdmitResult:
    """What admission decided for one slot."""

    cached_len: int                  # prompt positions served from cache
    cow_copies: List[Tuple[int, int]] = field(default_factory=list)
    new_blocks: int = 0              # freshly allocated (incl. COW copies)


class BlockAllocator:
    """Refcounted free-list allocator over ``n_blocks`` physical blocks."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need at least one block, got {n_blocks}")
        self.n_blocks = n_blocks
        self.refcount = np.zeros((n_blocks,), np.int32)
        self._free: Deque[int] = deque(range(n_blocks))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        b = self._free.popleft()
        if self.refcount[b] != 0:
            raise RuntimeError(
                f"block {b} was on the free list with refcount "
                f"{self.refcount[b]}")
        self.refcount[b] = 1
        return b

    def incref(self, b: int) -> None:
        if self.refcount[b] <= 0:
            raise RuntimeError(f"incref on free block {b}")
        self.refcount[b] += 1

    def decref(self, b: int) -> bool:
        """Drop one hold; returns True when the block became free."""
        if self.refcount[b] <= 0:
            raise RuntimeError(f"decref on free block {b}")
        self.refcount[b] -= 1
        if self.refcount[b] == 0:
            self._free.append(b)
            return True
        return False


class PrefixCache:
    """hash-of-prefix -> physical block, LRU-ordered (front = coldest).

    Keys are exact chained prefixes (nested tuples), so a hit guarantees
    token-identical content — the repro trades the constant-size hashing
    of production stacks for collision-free bookkeeping.
    """

    def __init__(self):
        self._table: "OrderedDict[tuple, int]" = OrderedDict()
        self._key_of: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self._table)

    @staticmethod
    def chain_keys(tokens: Sequence[int], block_size: int) -> List[tuple]:
        """One key per FULL block of ``tokens``; key i commits to the
        entire prefix through block i (chained), not just block i."""
        keys, prev = [], None
        for i in range(len(tokens) // block_size):
            blk = tuple(int(t) for t in
                        tokens[i * block_size:(i + 1) * block_size])
            prev = (prev, blk)
            keys.append(prev)
        return keys

    def get(self, key: tuple) -> Optional[int]:
        b = self._table.get(key)
        if b is not None:
            self._table.move_to_end(key)
        return b

    def peek(self, key: tuple) -> Optional[int]:
        """Lookup WITHOUT touching LRU order — for feasibility queries
        (can_admit runs every scheduler step for the queue head; letting
        it refresh recency would let a never-admitted request pin its
        prefix at the MRU end and distort eviction)."""
        return self._table.get(key)

    def put(self, key: tuple, block: int) -> bool:
        """Register ``block`` under ``key``; keeps an earlier entry
        (first writer wins) and reports whether the put took."""
        if key in self._table:
            return False
        self._table[key] = block
        self._key_of[block] = key
        return True

    def holds(self, block: int) -> bool:
        return block in self._key_of

    def evict_lru(self, evictable) -> Optional[int]:
        """Drop the least-recently-used entry whose block ``evictable``
        approves (refcount == 1: the cache is the sole holder)."""
        for key, block in self._table.items():
            if evictable(block):
                del self._table[key]
                del self._key_of[block]
                return block
        return None


class BlockManager:
    """Per-slot block tables over one allocator + prefix cache.

    Admission is EAGER: ``admit`` attaches cached prefix blocks, performs
    any divergence-block COW, and allocates every block the request can
    touch over its lifetime (``reserve_len`` positions: prompt +
    max_tokens + adapter headroom) — so decode-time writes never allocate
    and can never fail mid-flight.  The scheduler gates admission on
    ``can_admit`` (free + evictable blocks), the paged analogue of
    "is a slot free".
    """

    def __init__(self, batch: int, max_len: int, block_size: int,
                 n_blocks: int, prefix_cache: bool = True):
        if max_len % block_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"kv block_size={block_size}")
        self.batch = batch
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        self.allocator = BlockAllocator(n_blocks)
        self.prefix = PrefixCache() if prefix_cache else None
        self.trash = n_blocks               # the extra write-dump block
        self.tables = np.full((batch, self.max_blocks), self.trash, np.int32)
        self._held: List[List[int]] = [[] for _ in range(batch)]
        # telemetry the scheduler surfaces in stats()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.cow_copies = 0
        self.evictions = 0
        self.peak_blocks_used = 0
        self.preemptions = 0
        self.preempt_blocks_freed = 0

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.allocator.n_blocks

    @property
    def n_phys(self) -> int:
        """Physical pool blocks including the trailing trash block."""
        return self.allocator.n_blocks + 1

    def blocks_used(self) -> int:
        return self.allocator.n_used

    def n_evictable(self) -> int:
        if self.prefix is None:
            return 0
        return sum(1 for b in self.prefix._key_of
                   if self.allocator.refcount[b] == 1)

    def available_blocks(self) -> int:
        return self.allocator.n_free + self.n_evictable()

    # ------------------------------------------------------------------
    def _match(self, tokens: Sequence[int]) -> Tuple[int, List[tuple]]:
        """Longest chain of cached full blocks matching ``tokens``.
        Read-only (no LRU touch) — ``admit``'s attach loop refreshes
        recency for the blocks it actually takes."""
        keys = (PrefixCache.chain_keys(tokens, self.block_size)
                if self.prefix is not None else [])
        matched = 0
        for key in keys:
            if self.prefix.peek(key) is None:
                break
            matched += 1
        return matched, keys

    def admission_cost(self, tokens: Sequence[int],
                       reserve_len: int) -> Tuple[int, int]:
        """(fresh blocks ``admit`` would allocate, currently-evictable
        cached blocks the admission would PIN by attaching).  Pinned
        blocks don't consume pool space but do shrink the evictable
        supply, so admission gating must budget ``needed + pinned``."""
        p = len(tokens)
        if reserve_len < p:
            raise ValueError("reserve_len must cover the prompt")
        matched, keys = self._match(tokens)
        cached_len = min(matched * self.block_size, p - 1)
        needed = (cdiv(reserve_len, self.block_size)
                  - cached_len // self.block_size)
        cow = cached_len < matched * self.block_size
        pinned = 0
        for i, key in enumerate(keys[:matched]):
            if cow and i == matched - 1:
                # the COW source is not pinned: admit drops its hold on
                # it before allocating the copy (the copy itself is
                # already in ``needed``), so it stays evictable —
                # counting it too would gate a feasible admission out
                # forever on a tight pool
                continue
            b = self.prefix.peek(key)
            if b is not None and self.allocator.refcount[b] == 1:
                pinned += 1
        return needed, pinned

    def can_admit(self, tokens: Sequence[int], reserve_len: int) -> bool:
        needed, pinned = self.admission_cost(tokens, reserve_len)
        return needed + pinned <= self.available_blocks()

    # ------------------------------------------------------------------
    def _alloc_or_evict(self) -> int:
        if self.allocator.n_free == 0 and self.prefix is not None:
            victim = self.prefix.evict_lru(
                lambda b: self.allocator.refcount[b] == 1)
            if victim is not None:
                self.allocator.decref(victim)      # the cache's hold
                self.evictions += 1
        b = self.allocator.alloc()
        self.peak_blocks_used = max(self.peak_blocks_used,
                                    self.allocator.n_used)
        return b

    def admit(self, slot: int, tokens: Sequence[int],
              reserve_len: int) -> AdmitResult:
        """Build slot ``slot``'s block table for a request of
        ``len(tokens)`` prompt positions and ``reserve_len`` total
        positions.  Returns the cached prefix length and any COW
        device copies the engine must apply BEFORE writing.

        At least one prompt position is always recomputed (the last-
        position logits seed generation), so a fully cached prompt caps
        ``cached_len`` at ``p - 1`` — the divergence then falls inside
        the final shared block and triggers the COW copy.
        """
        p = len(tokens)
        if p < 1:
            raise ValueError("empty prompt")
        if reserve_len < p or reserve_len > self.max_len:
            raise ValueError(f"reserve_len={reserve_len} outside "
                             f"[prompt={p}, max_len={self.max_len}]")
        if self._held[slot]:
            raise RuntimeError(f"slot {slot} already admitted")
        bs = self.block_size
        matched, keys = self._match(tokens)
        cached_len = min(matched * bs, p - 1)

        held: List[int] = []
        result = AdmitResult(cached_len=cached_len)
        snapshot = (self.cow_copies,)
        try:
            # attach the matched read-only prefix blocks
            for i in range(matched):
                b = self.prefix.get(keys[i])
                self.allocator.incref(b)
                self.tables[slot, i] = b
                held.append(b)
            # divergence inside the last shared block -> copy-on-write.
            # Drop our hold on the source BEFORE allocating the copy:
            # the source stays resident under the cache's hold, remains
            # evictable, and may even legitimately be the block LRU
            # eviction hands back as the copy target (an identity copy)
            # — this keeps admission_cost's supply math exact.
            if cached_len < matched * bs:
                src = int(self.tables[slot, matched - 1])
                held[matched - 1] = None
                self.allocator.decref(src)
                dst = self._alloc_or_evict()
                result.cow_copies.append((src, dst))
                result.new_blocks += 1
                self.cow_copies += 1
                self.tables[slot, matched - 1] = dst
                held[matched - 1] = dst
            # fresh blocks for suffix + generation + headroom reservation
            for i in range(matched, cdiv(reserve_len, bs)):
                b = self._alloc_or_evict()
                result.new_blocks += 1
                self.tables[slot, i] = b
                held.append(b)
        except RuntimeError:
            # atomic admission: a mid-flight pool exhaustion rolls every
            # hold back so refcount invariants survive the failure
            # (evictions already performed are real and stay; a None
            # placeholder marks the COW source whose hold was already
            # dropped)
            for b in held:
                if b is not None:
                    self.allocator.decref(b)
            self.tables[slot, :] = self.trash
            (self.cow_copies,) = snapshot
            raise
        self._held[slot] = held
        self.lookups += 1
        if cached_len > 0:
            self.hits += 1
            self.hit_tokens += cached_len
        return result

    def register_prompt(self, slot: int, tokens: Sequence[int]) -> int:
        """Register the slot's full prompt blocks in the prefix cache
        (call AFTER prefill has filled them).  First writer wins: a key
        already cached keeps its existing block.  Returns the number of
        newly registered blocks (each takes one cache hold)."""
        if self.prefix is None:
            return 0
        new = 0
        for i, key in enumerate(PrefixCache.chain_keys(tokens,
                                                       self.block_size)):
            b = int(self.tables[slot, i])
            if self.prefix.put(key, b):
                self.allocator.incref(b)
                new += 1
        return new

    def release(self, slot: int) -> int:
        """Drop the slot's holds; prefix-cached blocks stay resident
        under the cache's own hold until eviction recycles them.
        Returns how many blocks became free."""
        freed = 0
        for b in self._held[slot]:
            if self.allocator.decref(b):
                freed += 1
        self._held[slot] = []
        self.tables[slot, :] = self.trash
        return freed

    def preempt(self, slot: int) -> int:
        """Eviction-by-preemption: same hold-dropping as ``release`` but
        counted separately — the scheduler evicts a LIVE request whose
        KV will be recomputed at resume, so these frees measure wasted
        (to-be-recomputed) work, not retirement.  Blocks the prefix
        cache also holds survive; a resume whose context still matches
        them skips that recompute."""
        freed = self.release(slot)
        self.preemptions += 1
        self.preempt_blocks_freed += freed
        return freed

    # ------------------------------------------------------------------
    def device_tables(self) -> np.ndarray:
        """(batch, max_blocks) int32 snapshot for the decode forward."""
        return self.tables.copy()

    def check_invariants(self) -> None:
        """Refcount of every block == holds by slots + the prefix cache
        hold; free blocks appear in no table row and no cache entry."""
        holds = np.zeros((self.n_blocks,), np.int64)
        for held in self._held:
            for b in held:
                holds[b] += 1
        if self.prefix is not None:
            for b in self.prefix._key_of:
                holds[b] += 1
        if not np.array_equal(holds, self.allocator.refcount.astype(np.int64)):
            bad = np.nonzero(holds !=
                             self.allocator.refcount.astype(np.int64))[0]
            raise AssertionError(f"refcount drift on blocks {bad.tolist()}")
        free = set(self.allocator._free)
        for b in free:
            if self.allocator.refcount[b] != 0:
                raise AssertionError(f"free block {b} has refcount")
        used_in_tables = set(int(b) for row in self._held for b in row)
        if used_in_tables & free:
            raise AssertionError("held block on the free list")

    def stats(self) -> Dict[str, int]:
        return {
            "kv_blocks": self.n_blocks,
            "kv_block_size": self.block_size,
            "kv_blocks_used": self.blocks_used(),
            "kv_blocks_peak": self.peak_blocks_used,
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.evictions,
            "kv_preemptions": self.preemptions,
            "kv_preempt_blocks_freed": self.preempt_blocks_freed,
        }
