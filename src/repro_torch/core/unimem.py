"""UniMem — the paper's single-form pooled memory, as a page-pool arena.

Port of `repro.core.unimem`: the host-side control plane (page tables,
free lists, refcounts, pinning, the sharded pool's per-bank accounting)
is copied as plain Python, and the quantized-page contract
(`quantize_kv`/`dequantize_kv`) is rewritten in torch with the same
numerics.  The device arena itself is owned by `serve/kv_cache.py` (one
pool) and `serve/sharded/arena.py` (a bank per shard).

`HostTier` is the LRU bank of host-DRAM page parcels behind the device
pool: preempted sequences spill their exact KV bytes instead of dropping
them, and readmission restores them (through an asynchronous prefetch
on the card) instead of recomputing.  A parcel's payload is CPU tensors
(pinned where the arena is on CUDA), since bf16 has no numpy dtype.

`ShardedUniMemPool` spreads the pool over near-memory banks: logical
page j of a sequence lives on bank (rotation + j) % n.  The allocator's
`start` (the logical index the first new page serves) and
`SequencePageTable.rotation` feed that placement; a single pool ignores
both.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import torch


class UniMemOOM(RuntimeError):
    pass


# ------------------------------------------------------- quantized pages

# Arena leaves holding physical KV pages (page-slot axis 1) and, in the
# quantized modes, their per-token-per-head f32 scales.
PAGED_KV_KEYS = ("k", "v")
PAGED_SCALE_KEYS = ("k_scale", "v_scale")

# clip targets of the quantized stores: int8 is the symmetric integer
# range; fp8 (e4m3fn) MUST be clipped to its finite max before the cast
# — out-of-range f32 -> e4m3fn casts produce NaN, not saturation.
KV_QMAX = {"int8": 127.0, "fp8": 448.0}


def is_page_leaf(name: str) -> bool:
    """True for arena leaves with the page-slot axis at position 1
    (K/V banks and their scale siblings)."""
    return name in PAGED_KV_KEYS or name in PAGED_SCALE_KEYS


def scale_key(kv_key: str) -> str:
    return f"{kv_key}_scale"


def quantize_kv(x: torch.Tensor, store_dtype: torch.dtype):
    """Quantize K or V activations to `store_dtype` with one f32 scale
    per (token, kv head) — amax over the head_dim lane axis.

    x: (..., hkv, hd) floating -> (q (..., hkv, hd) store_dtype,
    scale (..., hkv) f32).  Zero rows get scale 0 (and quantize to 0),
    so null-page garbage dequantizes to exact zeros.  int8 rounds half
    to even (`torch.round`, like `jnp.round`)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)                               # (..., hkv)
    if store_dtype == torch.int8:
        qmax = KV_QMAX["int8"]
    elif store_dtype == torch.float8_e4m3fn:
        qmax = KV_QMAX["fp8"]
    else:
        raise ValueError(f"not a quantized KV dtype: {store_dtype}")
    scale = amax / qmax
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    y = xf * inv[..., None]
    if store_dtype == torch.int8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(store_dtype)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv`: q (..., hkv, hd) x scale (..., hkv)
    -> f32 (..., hkv, hd)."""
    return q.float() * scale.float()[..., None]


@dataclass
class PoolStats:
    num_pages: int
    free_pages: int
    allocated_pages: int
    shared_pages: int
    utilization: float
    peak_allocated_pages: int = 0
    # pages held ONLY by the prefix store (refcount-0 entries): allocated
    # but idle
    pinned_pages: int = 0
    # high-water mark of allocated MINUS pinned pages
    peak_hot_pages: int = 0


@dataclass
class UniMemPool:
    """Fixed-size page pool with refcounted pages (prefix sharing)."""
    num_pages: int
    page_size: int                      # tokens per page
    _free: list[int] = field(default_factory=list)
    _refcount: dict[int, int] = field(default_factory=dict)
    _peak: int = 0

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refcount = {}
        self._peak = 0
        self._pinned: set[int] = set()
        self._peak_hot = 0

    # ------------------------------------------------------------- alloc

    def alloc(self, n: int = 1, start: int | None = None) -> list[int]:
        """Allocate n pages.  `start` is the LOGICAL page index the first
        new page will serve in its sequence: ignored here, consumed by
        the sharded pool's page -> bank placement."""
        del start
        if len(self._free) < n:
            raise UniMemOOM(
                f"UniMem pool exhausted: want {n} pages, {len(self._free)} free "
                f"of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        self._note_peak()
        return pages

    def _note_peak(self) -> None:
        alloc = self.num_pages - len(self._free)
        self._peak = max(self._peak, alloc)
        self._peak_hot = max(self._peak_hot, alloc - len(self._pinned))

    def fits(self, start: int, n: int) -> bool:
        """Would `alloc(n, start)` succeed right now?  (The sharded pool
        answers per bank.)"""
        del start
        return n <= len(self._free)

    def share(self, pages: list[int]) -> list[int]:
        """Bump refcounts — a second sequence now references these pages."""
        for p in pages:
            if p not in self._refcount:
                raise KeyError(f"page {p} is not allocated")
            self._refcount[p] += 1
        return list(pages)

    def free(self, pages: list[int]) -> None:
        for p in pages:
            rc = self._refcount.get(p)
            if rc is None:
                raise KeyError(f"double free of page {p}")
            if rc == 1:
                if p in self._pinned:
                    raise RuntimeError(
                        f"freeing pinned page {p}: cache-resident pages must "
                        f"be unpinned before their last reference drops")
                del self._refcount[p]
                self._free.append(p)
            else:
                self._refcount[p] = rc - 1

    # ----------------------------------------------------------- pinning

    def pin(self, page: int) -> None:
        if page not in self._refcount:
            raise KeyError(f"page {page} is not allocated")
        self._pinned.add(page)

    def unpin(self, page: int) -> None:
        self._pinned.discard(page)
        self._note_peak()

    def is_pinned(self, page: int) -> bool:
        return page in self._pinned

    @property
    def pinned_pages(self) -> int:
        return len(self._pinned)

    def is_allocated(self, page: int) -> bool:
        return page in self._refcount

    def is_shared(self, page: int) -> bool:
        return self._refcount.get(page, 0) > 1

    def shard_of(self, page: int) -> int:
        """The bank that owns a page: a single pool is one bank."""
        return 0

    # ------------------------------------------------------------- stats

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_admit(self, num_tokens: int) -> bool:
        """Would a sequence of `num_tokens` fit right now (the contiguous
        layout's full-footprint reservation)?"""
        return self.pages_for(num_tokens) <= self.free_pages

    def stats(self) -> PoolStats:
        alloc = self.num_pages - len(self._free)
        shared = sum(1 for rc in self._refcount.values() if rc > 1)
        return PoolStats(
            num_pages=self.num_pages,
            free_pages=len(self._free),
            allocated_pages=alloc,
            shared_pages=shared,
            utilization=alloc / self.num_pages if self.num_pages else 0.0,
            peak_allocated_pages=self._peak,
            pinned_pages=len(self._pinned),
            peak_hot_pages=self._peak_hot,
        )


@dataclass
class ShardedUniMemPool(UniMemPool):
    """The pool spread over `num_shards` near-memory banks (DESIGN.md
    §2).  Physical ids are blocked per bank (page p lives on bank
    p // pages_per_shard), while LOGICAL placement is strided: logical
    page j of a sequence is allocated from bank (rotation + j) % n (the
    rotation arrives folded into `start` by `SequencePageTable`), so a
    sequence's pages interleave over every bank and each bank's walk of
    it is n times shorter.  A replacement (copy on write) or shared page
    serves the same logical index, hence stays on its bank.  An alloc
    raises UniMemOOM when the OWNING bank is full even if others have
    room: per-bank backpressure, which the engine answers with
    preemption as for a full single pool."""
    num_shards: int = 1

    def __post_init__(self):
        if self.num_pages % self.num_shards:
            raise ValueError(
                f"num_pages {self.num_pages} must divide over "
                f"{self.num_shards} shards")
        super().__post_init__()
        self._shard_peak = [0] * self.num_shards
        # per-bank free counts, kept incrementally: fits() runs at every
        # admission attempt
        self._free_counts = [self.pages_per_shard] * self.num_shards

    @property
    def pages_per_shard(self) -> int:
        return self.num_pages // self.num_shards

    def shard_of(self, page: int) -> int:
        """The owning bank: blocked id layout, as the arena's banks."""
        return page // self.pages_per_shard

    def _shard_free(self) -> list[int]:
        return list(self._free_counts)

    def free(self, pages: list[int]) -> None:
        returned = len(self._free)
        super().free(pages)
        for p in self._free[returned:]:       # only last-ref pages return
            self._free_counts[self.shard_of(p)] += 1

    def _demand(self, start: int | None, n: int) -> list[int]:
        """Per-bank demand of an alloc: strided from logical index
        `start`; spread to the least-loaded banks when untracked."""
        demand = [0] * self.num_shards
        if start is None:
            supply = self._shard_free()
            for _ in range(n):
                s = max(range(self.num_shards),
                        key=lambda i: supply[i] - demand[i])
                demand[s] += 1
            return demand
        for k in range(n):
            demand[(start + k) % self.num_shards] += 1
        return demand

    def fits(self, start: int, n: int) -> bool:
        supply = self._shard_free()
        return all(d <= s for d, s in zip(self._demand(start, n), supply))

    def alloc(self, n: int = 1, start: int | None = None) -> list[int]:
        demand = self._demand(start, n)
        supply = self._shard_free()
        short = [(i, d, s) for i, (d, s) in enumerate(zip(demand, supply))
                 if d > s]
        if short:                       # raise BEFORE any mutation
            i, d, s = short[0]
            raise UniMemOOM(
                f"UniMem shard {i} exhausted: want {d} pages, {s} free of "
                f"{self.pages_per_shard} (pool: {len(self._free)} free of "
                f"{self.num_pages})")
        pages = []
        by_shard: dict[int, list[int]] = {}
        for idx in range(len(self._free) - 1, -1, -1):   # LIFO per bank
            by_shard.setdefault(self.shard_of(self._free[idx]), []).append(idx)
        if start is None:
            order = [s for s, d in enumerate(demand) for _ in range(d)]
        else:
            order = [(start + k) % self.num_shards for k in range(n)]
        for s in order:
            pages.append(self._free[by_shard[s].pop(0)])
        for p in pages:
            self._free.remove(p)
            self._refcount[p] = 1
            s = self.shard_of(p)
            self._free_counts[s] -= 1
            self._shard_peak[s] = max(self._shard_peak[s],
                                      self.pages_per_shard
                                      - self._free_counts[s])
        self._note_peak()
        return pages

    def shard_stats(self) -> list[dict]:
        """Per-bank free, allocated, pinned and peak page counts.  Pinned
        pages count as allocated (they occupy their bank)."""
        free = self._shard_free()
        pinned = [0] * self.num_shards
        for p in self._pinned:
            pinned[self.shard_of(p)] += 1
        return [dict(shard=s, free_pages=free[s],
                     allocated_pages=self.pages_per_shard - free[s],
                     pinned_pages=pinned[s],
                     peak_allocated_pages=self._shard_peak[s])
                for s in range(self.num_shards)]


@dataclass
class SequencePageTable:
    """Per-sequence logical->physical page map, length in tokens.
    Allocations carry the LOGICAL index of the page they extend, offset
    by `rotation`, so a sharded pool keeps logical page j on bank
    (rotation + j) % n.  `rotation` is the per-prompt bank offset (the
    engine derives it from the prompt's first page; inert on a single
    pool): without it page 0 of every sequence would land on bank 0."""
    pool: UniMemPool
    pages: list[int] = field(default_factory=list)
    num_tokens: int = 0
    rotation: int = 0

    def append_tokens(self, n: int) -> list[int]:
        """Extend by n tokens, allocating pages as needed (copy-on-write is
        the caller's job for shared last pages)."""
        need = self.pool.pages_for(self.num_tokens + n) - len(self.pages)
        new = (self.pool.alloc(need, start=self.rotation + len(self.pages))
               if need > 0 else [])
        self.pages.extend(new)
        self.num_tokens += n
        return new

    def fork(self) -> "SequencePageTable":
        """Share the full prefix with a new sequence (no copy)."""
        self.pool.share(self.pages)
        return SequencePageTable(self.pool, list(self.pages), self.num_tokens,
                                 self.rotation)

    def cow_last_page(self) -> tuple[int, int] | None:
        """Copy-on-write: swap a SHARED last page for a private one before
        writing into it.  Returns (src, dst) physical ids so the caller
        can copy the device page, or None when nothing is to do.  The
        replacement serves the same logical index, so it lands on the
        same bank."""
        if not self.pages or not self.pool.is_shared(self.pages[-1]):
            return None
        src = self.pages[-1]
        dst = self.pool.alloc(1, start=self.rotation + len(self.pages) - 1)[0]
        self.pool.free([src])               # drop our ref; peers keep theirs
        self.pages[-1] = dst
        return src, dst

    def truncate(self, num_tokens: int) -> list[int]:
        """Roll the sequence back to `num_tokens`, freeing tail pages the
        shorter length no longer needs.  Returns the freed physical ids."""
        if num_tokens > self.num_tokens:
            raise ValueError(
                f"truncate to {num_tokens} tokens > current {self.num_tokens}")
        keep = self.pool.pages_for(num_tokens)
        dropped = self.pages[keep:]
        if dropped:
            self.pool.free(dropped)
            del self.pages[keep:]
        self.num_tokens = num_tokens
        return dropped

    def release(self) -> None:
        self.pool.free(self.pages)
        self.pages, self.num_tokens = [], 0


# ------------------------------------------------------------- host tier

@dataclass
class HostParcel:
    """One spilled sequence (or one cold prefix page): its page payloads
    (CPU tensors, one leading-axis entry per page after the layer axis)
    plus the engine metadata needed to rebuild the slot exactly (token
    count, generated tail)."""
    uid: object                    # request uid, or ("prefix", hash)
    num_pages: int
    data: dict                     # leaf name -> (L, npages, ...) CPU tensor
    meta: dict = field(default_factory=dict)


class HostTier:
    """LRU host-DRAM cold bank behind the device page pool: capacity is
    counted in PAGES.  Parcels are whole per-sequence spills, so the
    pages of one sequence live and die together and a restore is one
    batched write-back.

    Eviction (capacity pressure) drops the oldest parcel; its sequence
    falls back to the engine's replay/recompute admission, so the tier is
    a fast path, never a correctness dependency."""

    def __init__(self, capacity_pages: int):
        self.capacity_pages = int(capacity_pages)
        self._parcels: "OrderedDict[object, HostParcel]" = OrderedDict()
        self._resident = 0
        self._peak = 0
        self.spills = 0
        self.spilled_pages = 0
        self.prefetches = 0
        self.restores = 0
        self.restored_pages = 0
        self.evictions = 0
        self.evicted_pages = 0

    def __contains__(self, uid) -> bool:
        return uid in self._parcels

    @property
    def resident_pages(self) -> int:
        return self._resident

    def put(self, parcel: HostParcel) -> bool:
        """Spill a parcel, evicting LRU parcels to make room.  Returns
        False (and stores nothing) when the parcel alone exceeds
        capacity."""
        if parcel.num_pages > self.capacity_pages:
            return False
        self.take(parcel.uid)                     # replace, don't double-count
        while self._resident + parcel.num_pages > self.capacity_pages:
            _, old = self._parcels.popitem(last=False)
            self._resident -= old.num_pages
            self.evictions += 1
            self.evicted_pages += old.num_pages
        self._parcels[parcel.uid] = parcel
        self._resident += parcel.num_pages
        self._peak = max(self._peak, self._resident)
        self.spills += 1
        self.spilled_pages += parcel.num_pages
        return True

    def peek(self, uid) -> HostParcel | None:
        """Touch (LRU move-to-end) and return the parcel, still resident."""
        p = self._parcels.get(uid)
        if p is not None:
            self._parcels.move_to_end(uid)
        return p

    def take(self, uid) -> HostParcel | None:
        """Remove and return the parcel (restore or invalidation)."""
        p = self._parcels.pop(uid, None)
        if p is not None:
            self._resident -= p.num_pages
        return p

    def stats(self) -> dict:
        return dict(capacity_pages=self.capacity_pages,
                    resident_pages=self._resident,
                    peak_resident_pages=self._peak,
                    parcels=len(self._parcels),
                    spills=self.spills, spilled_pages=self.spilled_pages,
                    prefetches=self.prefetches,
                    restores=self.restores,
                    restored_pages=self.restored_pages,
                    evictions=self.evictions,
                    evicted_pages=self.evicted_pages)
