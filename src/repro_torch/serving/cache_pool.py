"""KV cache pools for continuous batching (port of
repro/serving/cache_pool.py: CachePool, PagedCachePool and their
helpers).

`CachePool` (the dense baseline, and the speculative draft's pool): every
slot owns max_len rows of every layer, (n_periods, max_batch, rows, ...)
with positions (n_periods, max_batch, rows) and -1 marking invalid rows.
Admission copies a prefilled batch-1 cache into the slot's row; eviction
blanks it.

`PagedCachePool`: attention KV lives in block ARENAS of (n_periods,
n_blocks, block_size, ...) addressed through per-slot block TABLES of
(max_batch, max_blocks) int32 arena indices, managed by the refcounted
host-side allocator of serving/block_allocator.py. Identical prompt prefixes are
content-addressed and stored once; eviction returns blocks to the free
list (or parks registered prefix blocks on the retained LRU); lazy
growth allocates decode blocks as each slot's cursor reaches them and
copy-on-writes a shared block at a ring wrap.

Speculative decoding writes K rows per slot per verify step, so the
paged rings carry a `row_margin` of K - 1 rows (rounded up to blocks;
models/decoder.paged_layout), and a rejected round rolls back by
rewinding the cursors and lowering the stale rows' positions to -1
(`rollback_rows`, both pools), never by copying a block.

Where the JAX pool rebuilt donated arenas through jitted scatters, the
port writes the arenas IN PLACE with indexed assignment; block 0 (the
null block) is never written, so its positions stay -1.

`EncDecCachePool` (the encoder-decoder family): self-attention KV dense
per slot, as in CachePool; the cross-attention K/V of one encoder input,
read-only for the request's life, in a refcounted block arena keyed by
the digest of the raw input frames (`frames_key`), so that requests
decoding the same input (beams, retries) share its blocks, and a
drained input's blocks stay warm on the retained LRU.

On a serving mesh (`mesh=`, one process per rank, every rank running
the same engine loop) each pool holds the rank's part of the cache, as
its ServeLayout (distributed/sharding.py) places it; serve_pspec states
the same placement as PSpecs of the whole cache. The slots are cut
over "data" in blocks, so a rank holds its block's rows (plus a dead
pad row where the block is one slot), its block-table rows, and its OWN
SHARE of every arena: n_blocks // data data blocks and a null block of
its own, addressed by local block ids.
Every rank keeps the host bookkeeping of every data rank's share (a
BlockTableMap per share and slot-type, `shards`), so that admission,
growth and preemption decide alike everywhere, and a slot is given
blocks only from its own rank's share: prefix sharing and the retained
LRU work within a share. Every in-place write (insert, evict, grow's
copy-on-write and fresh positions, rollback, the Mamba state) lands
only on the rank that holds the slot. Where the model axis cuts
attention on whole heads the K/V leaves hold the rank's n_kv / model
heads; where it cuts a Mamba-2 mixer on whole heads the slot-resident
state holds the rank's H / model heads and its conv channels
(ServeLayout.mamba, models/mamba2.py: local_cfg), else it stays whole
on every model rank.

Mamba slots (mamba2, jamba) keep their state SLOT-RESIDENT in both
pools: one fp32 (H, N, P) SSM state and (W - 1, C) conv tail per decode
slot, (n_periods, max_batch, ...), whatever the prompt's length, so
paging would buy no memory (and a prefix cannot be shared: the state
after it is folded into one tensor, not addressable rows). An insert
copies the request's state rows into the slot, an eviction writes the
blank (zero) state. A pool whose arch has no attention slot (mamba2)
holds no arena, no block table and checks no kernel layout.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import serve_layout
from repro_torch.models import decoder as dec_lib
from repro_torch.serving.block_allocator import BlockTableMap, NoBlocksError

PyTree = Any


def _mamba_slots(cfg) -> tuple:
    """The superblock's Mamba slot indices: their cache is slot-resident
    state (ssm, conv), the others' attention K/V."""
    return tuple(si for si, (mixer, _) in enumerate(cfg.superblock)
                 if mixer == "mamba")


def _state_insert(pool_leaf, req_leaf, slot: int):
    """Copy a batch-1 request cache's Mamba state (ssm, conv) into batch
    row `slot` of the pool's (n_periods, max_batch, ...) state."""
    for name in ("ssm", "conv"):
        pool_leaf[name][:, slot] = req_leaf[name][:, 0].to(
            pool_leaf[name].dtype)


def _state_blank(pool_leaf, slot: int):
    for name in ("ssm", "conv"):
        pool_leaf[name][:, slot] = 0


def _min_rows(pos, index, rows):
    """pos[:, index, rows] = min(pos[:, index, rows], -1): the speculative
    rollback's min-scatter (left-pad rows keep their lower positions, as
    in the JAX pool)."""
    pos[:, index, rows] = torch.clamp(pos[:, index, rows], max=-1)


class CachePool:
    """Owns the pooled per-slot decode cache and its insert / evict /
    rollback ops, on `device`; on a serving `mesh`, this rank's rows of
    it (the module docstring)."""

    def __init__(self, arch, max_batch: int, max_len: int, *,
                 device="cpu", mesh=None):
        self.arch = arch
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = torch.device(device)
        self.layout = serve_layout(arch.heads, max_batch, mesh, arch.mamba)
        self.cache = arch.init_cache(
            self.layout.rows, max_len, device=device,
            **self.layout.cache_kw(arch.heads[1]))
        self._mamba_slots = _mamba_slots(arch.cfg)

    def insert(self, request_cache: PyTree, slot: int):
        """Copy a prefilled batch-1 cache (max_len rows; Mamba state) into
        `slot`."""
        shard, row = self.layout.at(slot)
        if shard != self.layout.data_rank:
            return
        for pool, req in zip(self.cache["slots"], request_cache["slots"]):
            for name in pool:
                pool[name][:, row] = req[name][:, 0].to(pool[name].dtype)
        self.cache["index"][row] = request_cache["index"][0]

    def evict(self, slot: int):
        """Blank `slot`: zero K/V, positions -1, zero Mamba state, cursor
        0."""
        shard, row = self.layout.at(slot)
        if shard != self.layout.data_rank:
            return
        for si, pool in enumerate(self.cache["slots"]):
            if si in self._mamba_slots:
                _state_blank(pool, row)
                continue
            pool["k"][:, row] = 0
            pool["v"][:, row] = 0
            pool["pos"][:, row] = -1
        self.cache["index"][row] = 0

    def lengths(self):
        """Per-slot write cursors (host array) — diagnostic only."""
        return self.cache["index"].cpu().numpy()

    def rollback_rows(self, rows: dict, new_index, capacity: int):
        """Rewind after a speculative round (this pool holds the draft's
        cache): lower the positions of each slot's stale STORAGE rows to
        -1 (rows taken modulo each slot-type's own row count, which
        differs between full and sliding-window layers) and replace the
        write cursors. `capacity` bounds the stale rows, as in the JAX
        pool's fixed-shape scatter."""
        total = sum(len(r) for r in rows.values())
        assert total <= capacity, (total, capacity)
        lay = self.layout
        pairs = [(lay.local(slot), r) for slot, rws in rows.items()
                 if lay.owns(slot) for r in rws]
        b = torch.as_tensor([p[0] for p in pairs], dtype=torch.long,
                            device=self.device)
        for si, leaf in enumerate(self.cache["slots"] if pairs else ()):
            if si in self._mamba_slots:
                continue      # spec decoding serves attention-only archs
            L = leaf["pos"].shape[2]
            r = torch.as_tensor([p[1] % L for p in pairs], dtype=torch.long,
                                device=self.device)
            _min_rows(leaf["pos"], b, r)
        self.cache["index"] = torch.as_tensor(
            lay.local_rows(np.asarray(new_index, np.int32)),
            device=self.device)


def _arena_insert(arena, req, src_rows, dst_blocks, row_valid):
    """Write a prefilled request's cache rows into its fresh arena blocks.

    arena: {"k","v","pos"} with leading (n_periods, n_blocks) dims.
    req: the same slot-type of a batch-1 prefill cache, leading dims
      (n_periods, 1, cache_len).
    src_rows (ring_len,) np: request-cache row feeding each logical row.
    dst_blocks (max_blocks,) np: arena block per chain position, 0 for
      positions that must not be written (shared blocks, unused tail);
      those are skipped, so the null block is never written.
    row_valid (ring_len,) np bool: ring rows backed by a prompt row;
      unbacked rows of written blocks get position -1."""
    nbk = dst_blocks.shape[0]
    bs = arena["k"].shape[2]
    chain = np.nonzero(dst_blocks)[0]
    if chain.size == 0:
        return
    dev = arena["k"].device
    src = torch.as_tensor(src_rows, dtype=torch.long, device=dev)
    sel = torch.as_tensor(chain, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst_blocks[chain], dtype=torch.long, device=dev)

    def blocks_of(x):
        g = x[:, 0][:, src]                       # (n_periods, ring, ...)
        return g.reshape(g.shape[0], nbk, bs, *g.shape[2:])[:, sel]

    ok = torch.as_tensor(row_valid.reshape(nbk, bs)[chain], device=dev)
    pos = torch.where(ok[None], blocks_of(req["pos"]).to(torch.int32), -1)
    arena["k"][:, dst] = blocks_of(req["k"]).to(arena["k"].dtype)
    arena["v"][:, dst] = blocks_of(req["v"]).to(arena["v"].dtype)
    arena["pos"][:, dst] = pos


class PagedCachePool:
    """Block-paged decode cache with refcounted shared prompt prefixes.

    slots_budget sizes each attention arena in dense-slot equivalents:
    `slots_budget * ring_len // block_size` data blocks (+1 null); the
    default (== max_batch) matches a dense per-slot pool's memory. On a
    serving mesh each data rank's share holds that count // data, plus
    its own null block (the module docstring).
    """

    def __init__(self, arch, max_batch: int, max_len: int, *,
                 block_size: int = 16, slots_budget: Optional[int] = None,
                 share_prefix: bool = True,
                 attn_kernel: Optional[str] = None, growth: str = "eager",
                 retain_blocks: int = 0, watermark: int = 0,
                 row_margin: int = 0, device="cpu", mesh=None):
        """Args as the JAX pool's, plus `device`, where the arenas,
        tables and cursors live. row_margin widens every ring for a
        speculative verify burst (pass spec_k - 1). attn_kernel="paged"
        checks the layout against the kernel's limits here, at
        construction, for the widest launch the pool feeds (S =
        row_margin + 1 query rows, a model rank's heads): on CUDA a
        layout the kernel cannot take raises
        (kernels/paged_attention.ensure_kernel_fit); on the CPU the
        problems are kept in `tile_problems`. An arch whose config sets
        kernel_interpret runs the kernel's plain version and checks
        nothing."""
        if arch.kind != "decoder":
            raise NotImplementedError("paged serving is decoder-only")
        if attn_kernel is None:
            attn_kernel = getattr(arch.cfg, "attn_kernel", "xla")
        if attn_kernel not in ("xla", "paged"):
            raise ValueError(
                f"attn_kernel must be 'xla' or 'paged', got {attn_kernel}")
        if growth not in ("eager", "lazy"):
            raise ValueError(
                f"growth must be 'eager' or 'lazy', got {growth}")
        self.attn_kernel = attn_kernel
        self.arch = arch
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.growth = growth
        self.share_prefix = share_prefix
        self.row_margin = row_margin
        self.device = torch.device(device)
        lay = self.layout = serve_layout(arch.heads, max_batch, mesh,
                                         arch.mamba)
        budget = slots_budget if slots_budget is not None else max_batch
        layout = dec_lib.paged_layout(arch.cfg, max_len, block_size,
                                      row_margin)
        base = dec_lib.paged_layout(arch.cfg, max_len, block_size)
        n_blocks = {}
        for entry, base_entry in zip(layout, base):
            if entry is None:            # a Mamba slot: slot-resident
                continue
            (si, ring), (_, src_len) = entry, base_entry
            n_blocks[si] = (budget * (ring // block_size), ring, src_len)
        self.n_local = {si: n // lay.data for si, (n, _, _) in
                        n_blocks.items()}
        if any(n < 1 for n in self.n_local.values()):
            raise ValueError(f"an arena of {n_blocks} blocks leaves a data "
                             f"rank of {lay.data} no block")
        # one share of blocks per data rank, each with its own allocator,
        # tables of its slots and prefix registry
        self.shards = [
            {si: BlockTableMap(
                lay.block, ring, block_size, self.n_local[si] + 1,
                retain_limit=min(retain_blocks,
                                 max(self.n_local[si] - 1, 0)),
                watermark=min(watermark, max(self.n_local[si] - 1, 0)),
                src_len=src_len)
             for si, (_, ring, src_len) in n_blocks.items()}
            for _ in range(lay.data)]
        self.maps = self.shards[lay.data_rank]
        kv = lay.local_heads(arch.heads[1])
        full = arch.init_paged_cache(lay.rows, max_len,
                                     block_size=block_size,
                                     n_blocks=self.n_local, device=device,
                                     row_margin=row_margin,
                                     **lay.cache_kw(arch.heads[1]))
        full.pop("tables")               # host-owned: see device_tables()
        self.cache = full
        self._mamba_slots = _mamba_slots(arch.cfg)
        self.tile_problems: list = []
        if (attn_kernel == "paged" and self.maps
                and not arch.cfg.kernel_interpret):
            # checked for the first attention slot-type (all share the
            # heads and the arena dtype); an arch without one (mamba2)
            # launches no kernel and has nothing to check
            from repro_torch.kernels.paged_attention import ensure_kernel_fit
            cfg = arch.cfg
            self.tile_problems = ensure_kernel_fit(
                block_size, cfg.resolved_head_dim,
                lay.local_heads(cfg.n_heads), kv,
                full["slots"][min(self.maps)]["k"].dtype,
                S=row_margin + 1, device=self.device)
        self._pending_grown = {si: [] for si in self.maps}
        self.shared_hits = 0
        self._dev_tables = None

    # ---------------- layout helpers ----------------

    def device_tables(self):
        """Per-slot-type block tables of this rank's slots on the pool's
        device (None for Mamba slots; a pad row of nulls where the rank
        holds one slot), uploaded from the host mirror only after a
        mutation changed them."""
        if self._dev_tables is None:
            self._dev_tables = tuple(
                torch.as_tensor(self.layout.pad_rows(self.maps[si].table),
                                device=self.device)
                if si in self.maps else None
                for si in range(len(self.arch.cfg.superblock)))
        return self._dev_tables

    def _src_rows(self, ring: int, cache_len: int, plen: int,
                  padded_len: int):
        """(request-cache row backing each logical ring row, backed-row
        mask). `rolled` mirrors attention's prefill roll branch."""
        pad = padded_len - plen
        rolled = padded_len >= cache_len
        filler = (pad - 1) % cache_len if rolled else cache_len - 1
        src = np.full(ring, filler, np.int32)
        backed = np.zeros(ring, bool)
        ps = np.arange(max(0, plen - min(ring, cache_len)), plen)
        rows = (pad + ps) % cache_len if rolled else pad + ps
        src[ps % ring] = rows
        backed[ps % ring] = True
        return src, backed

    # ---------------- admission ----------------

    def admission_plan(self, prompt, plen: int, padded_len: int,
                       budget: int, *, share: Optional[bool] = None,
                       slot: Optional[int] = None) -> dict:
        """{slot-type: fresh blocks + retained revivals} an insert would
        consume; lazy growth counts prompt-backed positions only. `share`
        overrides share_prefix for this plan (a chunked admission passes
        False: see insert). On a data mesh the plan is for `slot`'s
        share, keyed (share, slot-type)."""
        if share is None:
            share = self.share_prefix
        shard, _ = self.layout.at(self.layout.lo if slot is None else slot)
        return {self.layout.plan_key(shard, si): sum(m.admission_plan(
            prompt, plen, padded_len, budget, share,
            lazy=self.growth == "lazy"))
            for si, m in self.shards[shard].items()}

    def admissible_blocks(self, slot: Optional[int] = None) -> dict:
        """Blocks admission may plan against, per attention slot-type
        (of `slot`'s share on a data mesh, keyed as admission_plan):
        free + reclaimable retained, minus the growth watermark."""
        shard, _ = self.layout.at(self.layout.lo if slot is None else slot)
        return {self.layout.plan_key(shard, si): m.admissible()
                for si, m in self.shards[shard].items()}

    def prefix_warm(self, prompt, plen: int, padded_len: int) -> bool:
        """Is the request's leading prompt block already resident (live
        shared or retained) in any attention slot-type's registry (of any
        data rank's share)? The prefix-affinity scheduling policy's
        admission signal."""
        return any(m.prefix_warm(prompt, plen, padded_len)
                   for maps in self.shards for m in maps.values())

    def insert(self, request_cache: PyTree, slot: int, *, prompt,
               plen: int, padded_len: int, budget: int,
               share: Optional[bool] = None):
        """Admit a prefilled request: reserve its block chain, write the
        fresh blocks, share/revive prefix blocks without copying, and set
        the slot's cursor to plen. Atomic: on NoBlocksError nothing is
        left allocated and the arenas are untouched. `share` overrides
        share_prefix for this insert: a chunked prefill passes False (its
        chunks change the reduction shapes, so its KV is not bit for bit
        a whole prefill's and must never be content-addressed). The
        request cache may be longer than a ring (the chunked prefill's
        unclamped sliding-window rows): _src_rows takes the ring's tail.
        Every rank books the chain; only the slot's rank writes."""
        shard, row = self.layout.at(slot)
        maps = self.shards[shard]
        if share is None:
            share = self.share_prefix
        placed = {}
        try:
            for si, m in maps.items():
                placed[si] = m.insert(row, prompt, plen, padded_len, budget,
                                      share, lazy=self.growth == "lazy")
        except NoBlocksError:
            for si in placed:
                maps[si].rollback_insert(row, placed[si])
            raise
        self.shared_hits += sum(p.shared for ps in placed.values()
                                for p in ps)
        if shard != self.layout.data_rank:
            return
        self._dev_tables = None
        for si, m in maps.items():
            cache_len = request_cache["slots"][si]["k"].shape[2]
            src, backed = self._src_rows(m.ring_len, cache_len, plen,
                                         padded_len)
            dst = np.zeros(m.max_blocks, np.int32)
            for p in placed[si]:
                if not p.shared:
                    dst[p.chain_pos] = p.block
            _arena_insert(self.cache["slots"][si],
                          request_cache["slots"][si], src, dst, backed)
        for si in self._mamba_slots:
            _state_insert(self.cache["slots"][si],
                          request_cache["slots"][si], row)
        self.cache["index"][row] = plen

    def evict(self, slot: int):
        """Return the slot's blocks to the allocator, blank its Mamba
        state and zero its cursor. Freed blocks keep their bytes; nothing
        references them."""
        shard, row = self.layout.at(slot)
        for m in self.shards[shard].values():
            m.evict(row)
        if shard != self.layout.data_rank:
            return
        self._dev_tables = None
        for si in self._mamba_slots:
            _state_blank(self.cache["slots"][si], row)
        self.cache["index"][row] = 0

    # ---------------- lazy growth ----------------

    def grow(self, slot: int, row: int) -> bool:
        """Back logical `row` (the slot's next decode write) with a block
        in every attention slot-type. Returns True when a table changed;
        flush_growth() must run before the next decode step. Raises
        NoBlocksError when an arena is exhausted (the engine preempts)."""
        shard, local = self.layout.at(slot)
        grew = False
        for si, m in self.shards[shard].items():
            n_cow = len(m._pending_cow)
            b = m.grow(local, row)
            if len(m._pending_cow) != n_cow:
                grew = True       # COW: dst takes its pos from the copy
            elif b is not None:
                if shard == self.layout.data_rank:
                    self._pending_grown[si].append(b)
                grew = True
        return grew

    def flush_growth(self):
        """Apply what grow() buffered: first the wrap-time copy-on-write
        block copies (k, v and pos, src -> dst), then position -1 over
        the plainly grown blocks (they hold a previous occupant's rows).
        Other data ranks' copies are theirs to make."""
        for d, maps in enumerate(self.shards):
            if d != self.layout.data_rank:
                for m in maps.values():
                    m._pending_cow.clear()
        if not (any(m._pending_cow for m in self.maps.values())
                or any(self._pending_grown.values())):
            return
        self._dev_tables = None
        for si, m in self.maps.items():
            arena = self.cache["slots"][si]
            if m._pending_cow:
                srcs, dsts = map(list, zip(*m._pending_cow))
                m._pending_cow.clear()
                s = torch.as_tensor(srcs, dtype=torch.long,
                                    device=self.device)
                d = torch.as_tensor(dsts, dtype=torch.long,
                                    device=self.device)
                for name in ("k", "v", "pos"):
                    arena[name][:, d] = arena[name][:, s]
            grown = self._pending_grown[si]
            if grown:
                arena["pos"][:, torch.as_tensor(
                    grown, dtype=torch.long, device=self.device)] = -1
                self._pending_grown[si] = []

    # ---------------- speculative rollback ----------------

    def rollback_rows(self, rows: dict, new_index, capacity: int):
        """Rewind after a speculative verify round: lower the positions of
        each slot's stale LOCAL rows (the verify rows past the accepted
        prefix, {slot: rows}) to -1 through the slot's table, and replace
        the write cursors wholesale (the device cursors advanced by K in
        the verify step). Only an invalidation: with the row margin no
        live query needs what those writes overwrote, so no block is
        copied and sharing is untouched. `capacity` bounds the stale
        rows, as in the JAX pool's fixed-shape scatter."""
        total = sum(len(r) for r in rows.values())
        assert total <= capacity, (total, capacity)
        lay = self.layout
        for si, m in self.maps.items():
            blks, offs = [], []
            for slot, rws in rows.items():
                if not lay.owns(slot):
                    continue
                for r in rws:
                    rr = r % m.ring_len
                    blks.append(int(m.table[lay.local(slot),
                                            rr // m.block_size]))
                    offs.append(rr % m.block_size)
            if blks:
                _min_rows(self.cache["slots"][si]["pos"],
                          torch.as_tensor(blks, dtype=torch.long,
                                          device=self.device),
                          torch.as_tensor(offs, dtype=torch.long,
                                          device=self.device))
        self.cache["index"] = torch.as_tensor(
            lay.local_rows(np.asarray(new_index, np.int32)),
            device=self.device)

    # ---------------- telemetry ----------------

    def _all_maps(self):
        return [m for maps in self.shards for m in maps.values()]

    @property
    def retained_hits(self) -> int:
        return sum(m.retained_hits for m in self._all_maps())

    @property
    def prefix_misses(self) -> int:
        return sum(m.prefix_misses for m in self._all_maps())

    @property
    def retained_hit_rate(self) -> float:
        from repro_torch.serving.metrics import hit_rate
        return hit_rate(self.retained_hits, self.prefix_misses)

    def check_invariants(self):
        """Assert every share's and slot-type's allocator/table/registry
        invariants."""
        for m in self._all_maps():
            m.check_invariants()


def frames_key(frames, padded_frames: int):
    """Content key of one encoder input in BlockTableMap token form: the
    sha256 of the raw fp32 frame bytes, spread over `padded_frames` int64
    pseudo-tokens. An input's cross K/V match another request's only
    when the whole input is identical (every frame feeds every block
    through the encoder's global attention), so every chain block of one
    input hashes identically and two inputs differing anywhere share
    nothing."""
    d = hashlib.sha256(
        np.ascontiguousarray(frames, np.float32).tobytes()).digest()
    return np.resize(np.frombuffer(d, np.int64), padded_frames)


def _cross_insert(arena, ck, cv, dst_blocks, n_frames: int):
    """Write one request's FRESH cross-attention blocks into the arena,
    in place.

    arena: {"k", "v"} (n_layers, n_blocks, bs, H, hd) and "pos"
      (n_blocks, bs), no layer dim (frame positions are the same in
      every layer).
    ck/cv: (n_layers, Sm, H, hd), the request's dense projections from
      the admission prefill, zero-padded here to the blocked length.
    dst_blocks (max_blocks,) np: arena block per chain position, 0 for
      positions that are not written (shared or revived blocks); those
      are skipped, so the null block is never written.
    Rows past n_frames get position -1 and never attend."""
    chain = np.nonzero(dst_blocks)[0]
    if chain.size == 0:
        return
    nbk = dst_blocks.shape[0]
    bs = arena["k"].shape[2]
    dev = arena["k"].device
    sel = torch.as_tensor(chain, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst_blocks[chain], dtype=torch.long, device=dev)

    def blocks_of(x, dtype):
        x = torch.nn.functional.pad(
            x, (0, 0, 0, 0, 0, nbk * bs - x.shape[1]))
        return x.reshape(x.shape[0], nbk, bs, *x.shape[2:])[:, sel].to(dtype)

    rows = torch.arange(nbk * bs, dtype=torch.int32,
                        device=dev).reshape(nbk, bs)[sel]
    arena["k"][:, dst] = blocks_of(ck, arena["k"].dtype)
    arena["v"][:, dst] = blocks_of(cv, arena["v"].dtype)
    arena["pos"][dst] = torch.where(rows < n_frames, rows, -1)


class EncDecCachePool:
    """Pooled serving cache of the encoder-decoder family.

    The cache is one dict the decode step reads (and writes the self
    part of, in place):
      {"slots": {"self": (L, B, rows, ...) KV}, "index": (B,),
       "cross": {"k"/"v": (L, n_blocks + 1, bs, H, hd),
                 "pos": (n_blocks + 1, bs), "table": (B, max_blocks)}}
    The table is uploaded from the host map after each insert and
    eviction, the only mutations that change it. On a serving mesh, this
    rank's part: its slots' rows, its share of the cross arena (n_blocks
    // data blocks and a null block of its own) and its heads (the
    module docstring)."""

    def __init__(self, arch, max_batch: int, max_len: int, *,
                 block_size: int = 16, slots_budget: Optional[int] = None,
                 share_prefix: bool = True, retain_blocks: int = 0,
                 device="cpu", mesh=None):
        """slots_budget sizes the cross arena in inputs (default
        max_batch): slots_budget * padded_frames // block_size blocks,
        plus the null block."""
        if arch.kind != "encdec":
            raise ValueError(
                f"EncDecCachePool needs an encdec arch, got {arch.kind}")
        cfg = arch.cfg
        self.arch = arch
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.share_prefix = share_prefix
        self.device = torch.device(device)
        lay = self.layout = serve_layout(arch.heads, max_batch, mesh)
        self.n_frames = cfg.n_frames
        self.padded_frames = -(-cfg.n_frames // block_size) * block_size
        budget = slots_budget if slots_budget is not None else max_batch
        n_blocks = budget * (self.padded_frames // block_size) // lay.data
        # budget 1, plen = padded_len = ring_len = padded_frames: decode
        # rows never overwrite the chain and the layout is never rolled,
        # so every block is content-keyed and shareable
        self.shards = [BlockTableMap(
            lay.block, self.padded_frames, block_size, n_blocks + 1,
            retain_limit=min(retain_blocks, max(n_blocks - 1, 0)),
            src_len=self.padded_frames) for _ in range(lay.data)]
        self.map = self.shards[lay.data_rank]
        H = lay.local_heads(cfg.n_heads)
        cache = arch.init_cache(lay.rows, max_len, device=device,
                                kv_heads=H)
        shape = (cfg.n_layers, n_blocks + 1, block_size, H, cfg.head_dim)
        dt = cfg.compute_dtype
        cache["cross"] = {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((n_blocks + 1, block_size), -1,
                              dtype=torch.int32, device=device),
        }
        self.cache = cache
        self._upload_table()
        self.shared_hits = 0   # cross blocks reused instead of re-written

    def _upload_table(self):
        self.cache["cross"]["table"] = torch.as_tensor(
            self.layout.pad_rows(self.map.table), device=self.device)

    # ---------------- admission ----------------

    def admission_plan(self, frames, slot: Optional[int] = None) -> dict:
        """{"cross": fresh blocks + retained revivals} an insert of this
        input would consume, for the engine's gate against
        admissible_blocks() (on a data mesh, in `slot`'s share, keyed
        (share, "cross"))."""
        shard, _ = self.layout.at(self.layout.lo if slot is None else slot)
        key = frames_key(frames, self.padded_frames)
        plan = self.shards[shard].admission_plan(
            key, self.padded_frames, self.padded_frames, 1,
            self.share_prefix)
        return {self.layout.plan_key(shard, "cross"): sum(plan)}

    def admissible_blocks(self, slot: Optional[int] = None) -> dict:
        shard, _ = self.layout.at(self.layout.lo if slot is None else slot)
        return {self.layout.plan_key(shard, "cross"):
                self.shards[shard].admissible()}

    def free_blocks(self) -> dict:
        return {"cross": self.map.alloc.n_free}

    def insert(self, request_cache: PyTree, slot: int, *, frames,
               cross_k, cross_v):
        """Admit one prefilled request: reserve (or share, or revive) its
        cross block chain, write the fresh blocks (a shared placement
        skips the write: the arena holds the content already), copy its
        self-attention rows into the slot and set its cursor. Atomic: on
        NoBlocksError nothing is left allocated and the cache is
        untouched.

        request_cache: {"slots", "index"}, the batch-1 slice of the
        admission prefill cache. cross_k / cross_v: (L, Sm, H, hd), the
        request's dense cross projections. frames: the raw (n_frames, d)
        input, used only for content keying."""
        shard, row = self.layout.at(slot)
        m = self.shards[shard]
        key = frames_key(frames, self.padded_frames)
        placed = m.insert(row, key, self.padded_frames,
                          self.padded_frames, 1, self.share_prefix)
        self.shared_hits += sum(p.shared for p in placed)
        if shard != self.layout.data_rank:
            return
        dst = np.zeros(m.max_blocks, np.int32)
        for p in placed:
            if not p.shared:
                dst[p.chain_pos] = p.block
        for name, leaf in self.cache["slots"]["self"].items():
            leaf[:, row] = request_cache["slots"]["self"][name][:, 0].to(
                leaf.dtype)
        self.cache["index"][row] = request_cache["index"][0]
        _cross_insert(self.cache["cross"], cross_k, cross_v, dst,
                      self.n_frames)
        self._upload_table()

    def evict(self, slot: int):
        """Release the slot's cross blocks (the last holder parks them
        warm when retention is on) and blank its self-attention rows:
        zero K/V, positions -1, cursor 0."""
        shard, row = self.layout.at(slot)
        self.shards[shard].evict(row)
        if shard != self.layout.data_rank:
            return
        leaf = self.cache["slots"]["self"]
        leaf["k"][:, row] = 0
        leaf["v"][:, row] = 0
        leaf["pos"][:, row] = -1
        self.cache["index"][row] = 0
        self._upload_table()

    # ---------------- introspection ----------------

    def lengths(self):
        """Per-slot write cursors (host array) — diagnostic only."""
        return self.cache["index"].cpu().numpy()

    @property
    def retained_hits(self) -> int:
        return sum(m.retained_hits for m in self.shards)

    @property
    def prefix_misses(self) -> int:
        return sum(m.prefix_misses for m in self.shards)

    @property
    def retained_hit_rate(self) -> float:
        from repro_torch.serving.metrics import hit_rate
        return hit_rate(self.retained_hits, self.prefix_misses)

    def retained_blocks(self) -> dict:
        return {"cross": sum(m.n_retained for m in self.shards)}

    def check_invariants(self):
        """Assert every share's cross map invariants."""
        for m in self.shards:
            m.check_invariants()
