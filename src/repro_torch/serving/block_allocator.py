"""Refcounted block allocator + block-table bookkeeping for the paged cache
(copy of repro/serving/block_allocator.py: host-side numpy only).

All state here is host-side (numpy / python): the device side of the paged
pool is just two kinds of arrays — block arenas `(n_blocks, block_size, ...)`
and block tables `(max_batch, max_blocks)` of int32 arena indices — and this
module decides what those tables contain. Splitting the bookkeeping from the
device scatters keeps the allocator a pure state machine, which is what the
hypothesis property tests in tests/test_serving_properties.py drive:

  * refcounts are never negative; free blocks always have refcount 0;
  * the free list, the live (ref > 0) blocks and the RETAINED (ref 0,
    content kept warm) blocks partition the arena (minus the reserved
    null block);
  * a block referenced by two slot tables is always a registered shared
    block (refcount == number of table references);
  * a retained block is never referenced by any table — live writes can
    therefore never alias retained content;
  * any sequence of insert/grow/evict ops returns every block: no leaks.

Block 0 is the reserved NULL block: unoccupied table entries point at it,
so the fixed-shape gather in the decode step always has a valid index to
read. Its position rows stay -1 forever (inserts route skipped chain
positions' writes there with invalid source rows, and evicted slots'
decode writes carry position -1), which masks it out of attention.

Prefix sharing: a chain block whose `block_size` rows are entirely prompt
tokens is content-addressed by (padded prefill length, the prompt tokens
up to the end of the block), realised as an INCREMENTAL sha256 chain —
digest_j = sha256(block_size, padded_len, tokens[0:(j+1)*bs]) built one
block at a time — so registry keys are O(1) bytes each instead of O(plen)
token tuples and a 32k-token system prompt does not hold megabytes of
boxed ints live. The padded length is part of the key because the
prefill's reduction shapes depend on it — two requests only share blocks
their own prefill would have filled with identical values.

Ring wrap vs sharing (sliding-window layers): under EAGER inserts,
blocks that decode will later overwrite are simply never shared — every
block a slot writes is exclusively owned from admission, no
copy-on-write needed. Under LAZY growth the same rule used to turn the
whole prompt prefix unshareable the moment any slot's budget could wrap
the ring, permanently disabling prefix sharing for long generations.
Lazy inserts therefore DO share fully-prompt blocks that decode may
later overwrite, and `grow()` copy-on-writes at wrap time: when the
cursor crosses into a chain position backed by a REGISTERED block, the
slot gets a fresh private block, the (src, dst) pair is queued on
`_pending_cow` for the pool to copy arena content device-side, and the
slot's reference on the shared block is released — the pre-wrap prefix
stays registered (live for other holders, or parked on the retained
LRU) and later waves keep hitting it. Unregistered private blocks
still wrap in place, copy-free.

Retained prefixes (`retain_limit > 0`): when the LAST holder of a
registered prefix block evicts, the block moves to a bounded LRU
"retained" list instead of the free list — its arena content stays
bitwise valid (no table references it, so nothing can write it), and a
later request with the same (padded_len, tokens) prefix REVIVES it
copy-free instead of re-prefilling its KV into a fresh block. Retained
blocks are reclaimed lazily: allocation pressure pops the LRU tail
(unregister + free) before ever failing, so retention can delay reuse
but never causes an allocation failure the free list alone would not
have had.

Chain growth (`lazy=True` inserts + `grow()`): admission allocates only
the chain positions the PROMPT occupies; decode-budget positions stay
NULL in the table and are allocated one block at a time as the write
cursor crosses block boundaries — or copy-on-written when the ring
wraps onto a shared prompt block (see above).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class NoBlocksError(RuntimeError):
    """Arena exhausted: the caller should keep the request queued (at
    admission) or preempt a victim slot (mid-decode growth)."""


NULL_BLOCK = 0


class BlockAllocator:
    """Free-list allocator with refcounts over blocks 1..n_blocks-1.

    Three disjoint states per data block: FREE (on the free list, ref 0),
    LIVE (ref > 0, referenced by tables) and RETAINED (ref 0, off the
    free list — a warm prefix block parked by release(keep=True) until
    revive()/reclaim() moves it back). `watermark` is advisory headroom
    the ADMISSION gate subtracts from the allocatable count so mid-decode
    growth rarely has to preempt; alloc() itself ignores it (growth is
    exactly what the watermark reserves blocks for).
    """

    def __init__(self, n_blocks: int, watermark: int = 0):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 data + null), got {n_blocks}")
        if watermark < 0 or watermark >= n_blocks - 1:
            raise ValueError(
                f"watermark {watermark} must be in [0, {n_blocks - 1})")
        self.n_blocks = n_blocks
        self.watermark = watermark
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._limbo: set = set()        # retained: ref 0, off the free list
        self.ref = np.zeros(n_blocks, np.int32)

    @property
    def n_free(self) -> int:
        """Blocks available for allocation (excludes null + retained)."""
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Blocks currently referenced by at least one table entry."""
        return int((self.ref[1:] > 0).sum())

    @property
    def n_retained(self) -> int:
        """Warm ref-0 blocks parked off the free list (reclaimable)."""
        return len(self._limbo)

    def alloc(self) -> int:
        """Take a free block (refcount 1); NoBlocksError when exhausted.
        Never touches retained blocks — the table map reclaims those
        explicitly (LRU order) before retrying."""
        if not self._free:
            raise NoBlocksError(f"all {self.n_blocks - 1} blocks in use")
        b = self._free.pop()
        self.ref[b] = 1
        return b

    def retain(self, block: int):
        """Add a reference to a live block (a shared-prefix hit)."""
        if not (0 < block < self.n_blocks) or self.ref[block] < 1:
            raise ValueError(f"retain of non-live block {block}")
        self.ref[block] += 1

    def release(self, block: int, keep: bool = False) -> bool:
        """Drop one reference; returns True when the block went FREE.
        keep=True parks a block whose refcount hits 0 in the retained
        set instead (returns False: the block is warm, not allocatable
        until reclaim())."""
        if not (0 < block < self.n_blocks) or self.ref[block] < 1:
            raise ValueError(f"release of non-live block {block}")
        self.ref[block] -= 1
        if self.ref[block] == 0:
            if keep:
                self._limbo.add(block)
                return False
            self._free.append(block)
            return True
        return False

    def revive(self, block: int):
        """Retained -> live (ref 1): a warm-prefix hit, content reused
        copy-free."""
        if block not in self._limbo:
            raise ValueError(f"revive of non-retained block {block}")
        self._limbo.discard(block)
        self.ref[block] = 1

    def reclaim(self, block: int):
        """Retained -> free list: the content is given up (LRU pressure
        or retain_limit shrink)."""
        if block not in self._limbo:
            raise ValueError(f"reclaim of non-retained block {block}")
        self._limbo.discard(block)
        self._free.append(block)

    def check_invariants(self):
        """Assert the free/live/retained partition and refcount sanity
        (test hook; also driven by the hypothesis state machine)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free blocks"
        assert NULL_BLOCK not in free, "null block on the free list"
        assert NULL_BLOCK not in self._limbo, "null block retained"
        assert (self.ref >= 0).all(), "negative refcount"
        assert all(self.ref[b] == 0 for b in free), "free block with refs"
        assert all(self.ref[b] == 0 for b in self._limbo), (
            "retained block with refs")
        live = {b for b in range(1, self.n_blocks) if self.ref[b] > 0}
        assert not (free & live) and not (free & self._limbo)
        assert not (live & self._limbo)
        assert free | live | self._limbo == set(range(1, self.n_blocks)), (
            "free + live + retained blocks do not partition the arena")


@dataclasses.dataclass(frozen=True)
class Placement:
    """One chain position of an insert plan."""
    chain_pos: int     # index into the slot's block table row
    block: int         # arena block id
    shared: bool       # True: reused an existing prefix block (no write)
    revived: bool = False   # True: the reuse hit the RETAINED list (the
    #                         block survived with zero holders in between)
    registered: bool = False  # True: THIS insert registered the block's
    #                           prefix key and counted the prefix_misses
    #                           increment — rollback's decrement keys off
    #                           this record, never off registry state
    #                           (which a same-admission LRU reclaim can
    #                           have churned since)


class BlockTableMap:
    """Block tables + allocator + prefix registry for ONE attention
    slot-type (full-attention and sliding-window layer types have
    different ring lengths, hence separate arenas and maps).

    `table` is the host mirror of the device block table handed to the
    jitted decode step: row `slot` lists the arena blocks backing that
    slot's logical rows [j*block_size, (j+1)*block_size), 0 = unbacked.

    `retain_limit` bounds the retained-LRU list (0 disables retention:
    the PR 3 free-on-last-release behaviour). `watermark` is forwarded
    to the allocator and only affects `admissible()`.

    `src_len` is the PREFILL window this map's inserts are backed from
    (defaults to ring_len). The speculative row_margin widens ring_len
    past the attention window while prefill caches stay window-sized, so
    the rolled-layout sharing exclusion keys off src_len — "can the
    prefill cache still back every prompt row of a full block" — not the
    widened ring.
    """

    def __init__(self, max_batch: int, ring_len: int, block_size: int,
                 n_blocks: int, *, retain_limit: int = 0,
                 watermark: int = 0, src_len: Optional[int] = None):
        if ring_len % block_size != 0:
            raise ValueError(
                f"cache length {ring_len} not a multiple of block_size "
                f"{block_size}")
        if retain_limit < 0:
            raise ValueError(f"retain_limit must be >= 0, got {retain_limit}")
        self.block_size = block_size
        self.ring_len = ring_len
        self.src_len = src_len if src_len is not None else ring_len
        self.max_blocks = ring_len // block_size
        self.retain_limit = retain_limit
        self.table = np.zeros((max_batch, self.max_blocks), np.int32)
        self.alloc = BlockAllocator(n_blocks, watermark=watermark)
        self._registry: Dict[bytes, int] = {}   # prefix key -> block
        self._block_key: Dict[int, bytes] = {}  # block -> prefix key
        # retained LRU: key -> block, oldest first (ref 0, warm content)
        self._retained: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self.retained_hits = 0     # revived warm blocks (survived ref 0)
        self.prefix_misses = 0     # registered prefix blocks written fresh
        # wrap-time copy-on-write: (src, dst) arena copies grow() queued;
        # the pool drains this and copies block content device-side
        # BEFORE the next decode write lands in dst.
        self._pending_cow: List[Tuple[int, int]] = []

    # ---------------- planning ----------------

    def _chain(self, prompt_key, plen: int, padded_len: int, budget: int,
               share: bool,
               lazy: bool = False) -> List[Tuple[int, Optional[bytes], bool]]:
        """(chain_pos, sharing key | None, prompt_backed) for every block
        the slot's full chain covers.

        Rows the slot touches: prompt rows 0..plen-1 plus decode writes at
        rows plen..plen+budget-2 (the final sampled token is never fed
        back). Ring wrap maps row r to r % ring_len. Under EAGER inserts
        chain positions that decode will overwrite are excluded from
        sharing (the slot writes them in place, so they must be
        exclusively owned); under LAZY inserts they stay shareable —
        grow() copy-on-writes the position at wrap time, so the shared
        content is never clobbered. A rolled prefill layout
        (padded_len > src_len: the prefill cache no longer backs every
        prompt row) is never content-addressable and excludes the whole
        insert either way. `prompt_backed` marks positions
        holding at least one prompt row — the ones a LAZY insert must
        allocate at admission (the rest grow on demand as the write
        cursor reaches them). Keys are snapshots of one sha256 chain over
        (block_size, padded_len, prompt tokens so far) — O(1) bytes per
        block.
        """
        bs, L = self.block_size, self.ring_len
        total_rows = plen + max(budget - 1, 0)
        wrap = total_rows > L
        chain_len = self.max_blocks if wrap else -(-total_rows // bs)
        overwritten = {(r % L) // bs for r in range(plen, total_rows)}
        prompt_backed = {(r % L) // bs for r in range(plen)}
        rolled = padded_len > self.src_len
        toks = np.asarray(prompt_key, np.int64)
        h = hashlib.sha256(np.array([bs, padded_len], np.int64).tobytes())
        out = []
        for j in range(chain_len):
            key = None
            if (j + 1) * bs <= plen:          # entirely prompt-backed
                h.update(toks[j * bs:(j + 1) * bs].tobytes())
                if share and not rolled and (lazy or j not in overwritten):
                    key = h.digest()
            out.append((j, key, j in prompt_backed))
        return out

    def admission_plan(self, prompt_key, plen: int, padded_len: int,
                       budget: int, share: bool = True,
                       lazy: bool = False) -> Tuple[int, int]:
        """(fresh blocks, warm retained hits) an insert would consume.

        Fresh blocks come off the free list (possibly via LRU reclaim);
        retained hits revive warm blocks. Their SUM is what admission
        subtracts from `admissible()` — a retained hit that pressure
        converts to a miss mid-insert costs one block either way, so the
        count is conversion-invariant. lazy=True restricts the plan to
        prompt-backed chain positions (decode positions grow on demand).
        """
        fresh = hits = 0
        for _, key, prompt_backed in self._chain(prompt_key, plen,
                                                 padded_len, budget, share,
                                                 lazy):
            if lazy and not prompt_backed:
                continue
            if key is not None and key in self._registry:
                if key in self._retained:
                    hits += 1
            else:
                fresh += 1
        return fresh, hits

    def blocks_needed(self, prompt_key, plen: int, padded_len: int,
                      budget: int, share: bool = True,
                      lazy: bool = False) -> int:
        """Fresh blocks an insert would consume (registry hits are free,
        whether live-shared or retained)."""
        return self.admission_plan(prompt_key, plen, padded_len, budget,
                                   share, lazy)[0]

    def admissible(self) -> int:
        """Blocks the ADMISSION gate may plan against: free + reclaimable
        retained, minus the growth watermark. Growth itself ignores the
        watermark — reserving headroom for it is the watermark's job."""
        return (self.alloc.n_free + self.alloc.n_retained
                - self.alloc.watermark)

    # ---------------- mutation ----------------

    def _alloc_block(self) -> int:
        """Allocate a fresh block, reclaiming the LRU-oldest retained
        block (unregister + free) under pressure before failing."""
        try:
            return self.alloc.alloc()
        except NoBlocksError:
            if not self._retained:
                raise
            key, b = self._retained.popitem(last=False)   # LRU oldest
            del self._registry[key]
            del self._block_key[b]
            self.alloc.reclaim(b)
            return self.alloc.alloc()

    def insert(self, slot: int, prompt_key, plen: int,
               padded_len: int, budget: int,
               share: bool = True, lazy: bool = False) -> List[Placement]:
        """Allocate/retain the slot's chain. Atomic: on NoBlocksError
        every block this call touched is released and the table row is
        left empty, so the caller can requeue the request.

        lazy=False reserves the WHOLE chain (prompt + decode budget) up
        front — a decoding slot can then never fail. lazy=True allocates
        only the prompt-backed positions; the caller must grow() the
        chain before each decode write (and preempt on NoBlocksError).
        """
        assert not self.table[slot].any(), f"slot {slot} table not empty"
        placed: List[Placement] = []
        try:
            for j, key, prompt_backed in self._chain(prompt_key, plen,
                                                     padded_len, budget,
                                                     share, lazy):
                if lazy and not prompt_backed:
                    continue
                if key is not None and key in self._registry:
                    b = self._registry[key]
                    if key in self._retained:       # warm ref-0 block
                        del self._retained[key]
                        self.alloc.revive(b)
                        self.retained_hits += 1
                        placed.append(Placement(j, b, True, revived=True))
                    else:
                        self.alloc.retain(b)
                        placed.append(Placement(j, b, True))
                else:
                    b = self._alloc_block()
                    placed.append(Placement(j, b, False,
                                            registered=key is not None))
                    if key is not None:
                        self._registry[key] = b
                        self._block_key[b] = key
                        self.prefix_misses += 1
        except NoBlocksError:
            self._rollback(placed)
            raise
        for p in placed:
            self.table[slot, p.chain_pos] = p.block
        return placed

    def _rollback(self, placed: List[Placement]):
        """Undo an insert's placements exactly. NOT plain _release(): a
        fresh block registered by THIS insert has no content yet and
        must never be parked warm — unregister + free it. Revived
        blocks (content still valid) go back to the retained list they
        came from, with the hit counter corrected; plain shared retains
        just drop the extra reference.

        Counter accounting pairs with the placement RECORD, not with
        registry state at rollback time: prefix_misses decrements only
        for placements flagged `registered` (the ones whose insert
        counted the matching increment). An LRU reclaim later in the
        same admission can unregister blocks between the increment and
        this rollback, so deriving the decrement from a _block_key
        lookup could double-count a miss that was already undone —
        driving the counter negative and retained_hit_rate above 1.0.
        The non-negative counter invariant is asserted by
        check_invariants and the hypothesis state machines."""
        for p in placed:
            if p.revived:
                self.alloc.release(p.block, keep=True)
                self._retained[self._block_key[p.block]] = p.block
                self.retained_hits -= 1
            elif p.shared:
                self.alloc.release(p.block)
            else:
                if p.registered:
                    key = self._block_key.pop(p.block, None)
                    if key is not None:
                        del self._registry[key]
                    self.prefix_misses -= 1   # never materialized
                self.alloc.release(p.block)
        assert self.prefix_misses >= 0 and self.retained_hits >= 0, (
            "rollback drove a hit/miss counter negative",
            self.prefix_misses, self.retained_hits)

    def rollback_insert(self, slot: int, placed: List[Placement]):
        """Undo a COMPLETED insert whose sibling slot-type failed (the
        pool's cross-map rollback): clear the table entries this insert
        wrote, then apply the same exact per-placement rollback the
        intra-map failure path uses — fresh registrations are freed and
        unregistered (their device content was never written), revived
        blocks are re-parked warm, shared retains are dropped."""
        for p in placed:
            self.table[slot, p.chain_pos] = NULL_BLOCK
        self._rollback(placed)

    def grow(self, slot: int, row: int) -> Optional[int]:
        """Back the chain position covering logical `row` (the next
        decode write) with an exclusively-owned block.

        Three cases:
          * position unbacked -> allocate a fresh block (plain growth);
          * position backed by an unregistered private block -> None
            (a whole-chain insert, a previous grow, or a ring wrap onto
            content nobody else can reference: write in place);
          * position backed by a REGISTERED prefix block (lazy sharing
            + ring wrap) -> copy-on-write: allocate a private dst,
            queue (src, dst) on `_pending_cow` for the pool's arena
            copy, and release this slot's reference on src — the prefix
            stays registered (live for other holders or parked on the
            retained LRU) and later waves keep sharing it. A sole
            holder with retention off skips the copy: the block is
            simply unregistered and written in place.

        Returns the newly allocated block id (ref 1, exclusively owned)
        or None when the slot writes in place. Raises NoBlocksError when
        free list AND retained LRU are both empty — the engine's
        preemption path; no state is mutated in that case. Grown/COW'd
        blocks hold decode writes only: never registered, shared, or
        retained."""
        j = (row % self.ring_len) // self.block_size
        src = int(self.table[slot, j])
        if src != NULL_BLOCK:
            key = self._block_key.get(src)
            if key is None:
                return None                    # private block: wrap in place
            if self.alloc.ref[src] == 1 and self.retain_limit == 0:
                # sole holder, no retention: nobody can ever hit the
                # registration again once we write — drop it, skip the copy
                del self._registry[key]
                del self._block_key[src]
                return None
            dst = self._alloc_block()
            self.table[slot, j] = dst
            self._pending_cow.append((src, dst))
            self._release(src)
            return dst
        b = self._alloc_block()
        self.table[slot, j] = b
        return b

    def _release(self, block: int) -> bool:
        """Drop one table reference. A registered prefix block whose last
        holder leaves is RETAINED (LRU, bounded) instead of freed when
        retention is on; anything else frees normally. Returns True when
        the block landed on the free list. (Rollback paths do NOT come
        through here — see _rollback: a block whose device content was
        never written must not be parked warm.)"""
        key = self._block_key.get(block)
        if (self.retain_limit > 0 and key is not None
                and self.alloc.ref[block] == 1):
            self.alloc.release(block, keep=True)
            self._retained[key] = block         # newest at the end
            while len(self._retained) > self.retain_limit:
                k, b = self._retained.popitem(last=False)
                del self._registry[k]
                del self._block_key[b]
                self.alloc.reclaim(b)
            return False
        freed = self.alloc.release(block)
        if freed and key is not None:
            del self._registry[self._block_key.pop(block)]
        return freed

    def evict(self, slot: int) -> List[int]:
        """Return the slot's blocks to the pool; yields the freed ids
        (retained blocks are parked warm, not freed, and not listed).
        Only for slots whose insert COMPLETED — an insert that failed
        midway in a sibling slot-type rolls back via rollback_insert."""
        freed = []
        for j in range(self.max_blocks):
            b = int(self.table[slot, j])
            if b != NULL_BLOCK and self._release(b):
                freed.append(b)
            self.table[slot, j] = NULL_BLOCK
        return freed

    # ---------------- introspection ----------------

    @property
    def n_shared(self) -> int:
        """Prefix blocks currently registered for content-address reuse
        (live shared blocks + warm retained blocks)."""
        return len(self._registry)

    @property
    def n_retained(self) -> int:
        """Warm ref-0 prefix blocks on the retained LRU."""
        return len(self._retained)

    def prefix_warm(self, prompt_key, plen: int, padded_len: int) -> bool:
        """Does the request's FIRST full prompt block hit the registry
        (live or retained)? The prefix-affinity scheduling policy's
        admission signal — cheap: one sha256 over block_size tokens."""
        bs = self.block_size
        if plen < bs or padded_len > self.src_len:
            return False
        h = hashlib.sha256(np.array([bs, padded_len], np.int64).tobytes())
        h.update(np.asarray(prompt_key, np.int64)[:bs].tobytes())
        return h.digest() in self._registry

    def check_invariants(self):
        """Assert table/refcount/registry/retained consistency: every
        table reference holds exactly one refcount, multiply-referenced
        blocks are registered shared prefixes, registered blocks are
        live or retained, retained blocks are never table-referenced
        (so live writes cannot alias them) and respect the LRU bound.
        Hit/miss telemetry counters are never negative — the rollback
        accounting contract that keeps retained_hit_rate <= 1.0."""
        self.alloc.check_invariants()
        assert self.prefix_misses >= 0, (
            "negative prefix_misses (rollback over-decremented)")
        assert self.retained_hits >= 0, (
            "negative retained_hits (rollback over-decremented)")
        counts = np.bincount(self.table.ravel(),
                             minlength=self.alloc.n_blocks)
        # every table reference holds exactly one refcount
        np.testing.assert_array_equal(counts[1:], self.alloc.ref[1:])
        # a block in two tables must be a registered shared block
        multi = {b for b in np.nonzero(counts > 1)[0] if b != NULL_BLOCK}
        assert multi <= set(self._block_key), (
            "unshared block referenced by multiple table entries", multi)
        # retained list: bounded, ref 0, registered, never in a table
        assert len(self._retained) <= max(self.retain_limit, 0), (
            "retained LRU exceeds its bound")
        assert len(self._retained) == self.alloc.n_retained
        for key, b in self._retained.items():
            assert self._registry.get(key) == b, "retained but unregistered"
            assert counts[b] == 0, f"retained block {b} aliased by a table"
            assert self.alloc.ref[b] == 0
        # registry consistency: every registered block is live or retained
        for key, b in self._registry.items():
            assert self._block_key.get(b) == key
            assert self.alloc.ref[b] > 0 or key in self._retained, (
                "registered block neither live nor retained", b)
