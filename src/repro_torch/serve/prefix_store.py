"""Persistent cross-request prefix cache over the UniMem pool.

Port of `repro.serve.prefix_store`.  The store keeps full
PROMPT pages alive after their owning sequence retires, so the next
request with the same prefix adopts the written pages instead of
prefilling them again.

* Entries are keyed by the engine's chained page-content hashes (hash i
  folds in hash i-1), and each entry records its PARENT hash: a chain is
  reusable only up to its first miss, and eviction is leaf-first, so an
  interior page is never dropped while a descendant still anchors a
  longer match.
* Each entry holds its OWN pool reference on top of whatever live page
  tables hold, so a registered page can never be freed behind the
  store's back; `refs` counts the LIVE tables that reference the entry
  (acquire/release), the pool refcount minus the store's one.
* At refs == 0 a persistent store PINS the page in the pool: allocated
  but idle, reclaimed only by LRU `evict()` when the engine's watermark
  paths ask for headroom.  A non-persistent store (the engine default)
  drops the entry the moment refs hits 0: the donor-lifetime semantics,
  through the same code path.
* Entries record the donor's shard `rotation`: on a sharded pool a
  follower adopting cached pages adopts the donor's rotation, so logical
  page j keeps serving bank (rotation + j) % n and the walk's rotation
  recovery (`block_table[:, 0] // pages_per_shard`) stays exact.  On
  one pool it is 0.
* With a `HostTier` attached, eviction spills the page's exact bytes to
  a host-DRAM parcel keyed ("prefix", hash); a later lookup that misses
  device-resident entries can `restore_cold` the parcel into a fresh
  page at its original logical index and rotation (so on its original
  bank).  The cold copy is a fast path, never a correctness dependency:
  a dropped parcel just means a prefill.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.core.unimem import HostParcel, HostTier, UniMemPool


def _cold_key(h: int) -> tuple:
    """HostTier key for a spilled cache page: the tuple namespace keeps
    prefix parcels from ever colliding with per-sequence uid parcels."""
    return ("prefix", h)


@dataclass
class PrefixEntry:
    page: int                  # physical page id (store holds one pool ref)
    parent: int | None         # hash of the preceding page in the chain
    index: int                 # logical page index within its prompt chain
    rotation: int              # shard rotation of the original owner
    refs: int = 0              # live page tables referencing via the store
    children: int = 0          # resident entries whose parent is this hash


class PrefixStore:
    """Refcounted, parent-linked, LRU-evictable page-content cache."""

    def __init__(self, pool: UniMemPool, *, persistent: bool = False,
                 arena=None, host_tier: HostTier | None = None):
        self.pool = pool
        self.persistent = persistent
        self.arena = arena
        self.host_tier = host_tier
        self._entries: "OrderedDict[int, PrefixEntry]" = OrderedDict()
        self._by_page: dict[int, int] = {}
        self.registered_pages = 0
        self.reused_pages = 0          # pages adopted from the store
        self.cross_request_hits = 0    # ... whose donor had fully let go
        self.evictions = 0
        self.cold_spills = 0
        self.cold_restores = 0

    # ------------------------------------------------------------ lookup

    def __contains__(self, h: int) -> bool:
        return h in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def page_of(self, h: int) -> int | None:
        """Resident page for hash h, or None (does not touch LRU)."""
        e = self._entries.get(h)
        return None if e is None else e.page

    def entry(self, h: int) -> PrefixEntry | None:
        return self._entries.get(h)

    def hash_of(self, page: int) -> int | None:
        """Reverse map: the hash a resident page is registered under."""
        return self._by_page.get(page)

    def rotation_of(self, h: int) -> int:
        return self._entries[h].rotation

    # ---------------------------------------------------------- register

    def register(self, h: int, page: int, *, parent: int | None,
                 index: int, rotation: int = 0,
                 adopt_ref: bool = False) -> int:
        """Publish `page` (already written with this chain position's KV)
        under hash h.  The store takes its own pool reference, via
        `share`, or by adopting the caller's fresh-alloc reference when
        `adopt_ref` (the cold-restore path).  Returns the resident page
        for h, the existing one on re-registration."""
        e = self._entries.get(h)
        if e is not None:
            self._entries.move_to_end(h)
            return e.page
        if page in self._by_page:
            # one physical page under two hashes would desync the reverse
            # map; unreachable, because identical content at the same
            # chain position hashes identically
            raise RuntimeError(
                f"page {page} already registered under hash "
                f"{self._by_page[page]:#x}")
        if not adopt_ref:
            self.pool.share([page])
        self.pool.pin(page)            # idle until first acquire
        e = PrefixEntry(page, parent, index, rotation)
        self._entries[h] = e
        self._by_page[page] = h
        if parent is not None:
            pe = self._entries.get(parent)
            if pe is not None:
                pe.children += 1
        self.registered_pages += 1
        return page

    # ----------------------------------------------------------- refcount

    def acquire(self, h: int, *, reuse: bool = False) -> int:
        """A live page table now references entry h (it also holds its
        own pool ref).  `reuse` marks adoption of a cached page (against
        a donor registering its own page) for the hit counters.  Returns
        the page."""
        e = self._entries[h]
        if reuse:
            self.reused_pages += 1
            if e.refs == 0:
                self.cross_request_hits += 1
        e.refs += 1
        if e.refs == 1:
            self.pool.unpin(e.page)
        self._entries.move_to_end(h)
        return e.page

    def release(self, h: int) -> None:
        """A referencing page table is going away.  At refs == 0 a
        persistent store pins the page (idle, evictable); a transient one
        drops the entry at once."""
        e = self._entries.get(h)
        if e is None:
            return                      # already evicted out from under us
        e.refs -= 1
        if e.refs < 0:
            raise RuntimeError(f"over-release of prefix entry {h:#x}")
        if e.refs == 0:
            if self.persistent:
                self.pool.pin(e.page)
            else:
                self._drop(h, spill=False)

    # ----------------------------------------------------------- eviction

    def _drop(self, h: int, *, spill: bool) -> None:
        e = self._entries.pop(h)
        if spill:
            self._spill_cold(h, e)
        del self._by_page[e.page]
        if e.parent is not None:
            pe = self._entries.get(e.parent)
            if pe is not None:
                pe.children -= 1
        self.pool.unpin(e.page)         # the pool refuses to free a pinned
        self.pool.free([e.page])        # page; this is the store's own ref

    def evict(self, need: int = 1, shards: set[int] | None = None,
              protect: set[int] | None = None) -> int:
        """Reclaim up to `need` idle pages, LRU-first among LEAF entries
        (children == 0: dropping an interior page would orphan the
        descendants that make longer matches possible) with refs == 0.
        `shards` narrows the candidates to pages on those banks (a
        strided admission's demand on a sharded pool); None means the
        whole pool.  `protect` entries are never victims (hashes an
        in-flight admission just matched).  Spills each victim to the
        host tier when one is attached.  Returns pages actually freed."""
        freed = 0
        while freed < need:
            victim = None
            for h, e in self._entries.items():      # insertion order = LRU
                if e.refs or e.children:
                    continue
                if protect is not None and h in protect:
                    continue
                if shards is not None and \
                        self.pool.shard_of(e.page) not in shards:
                    continue
                victim = h
                break
            if victim is None:
                break
            self._drop(victim, spill=True)
            self.evictions += 1
            freed += 1
        return freed

    @property
    def idle_pages(self) -> int:
        """Entries no live table references: the reclaimable set."""
        return sum(1 for e in self._entries.values() if e.refs == 0)

    def drop_all(self) -> None:
        """Release every idle entry (tests, shutdown).  Entries still
        referenced by live tables are kept."""
        for h in [h for h, e in self._entries.items() if e.refs == 0]:
            self._drop(h, spill=False)

    # ---------------------------------------------------------- cold tier

    def _spill_cold(self, h: int, e: PrefixEntry) -> None:
        if self.host_tier is None or self.arena is None:
            return
        parcel = HostParcel(uid=_cold_key(h), num_pages=1,
                            data=self.arena.read_page(e.page),
                            meta=dict(parent=e.parent, index=e.index,
                                      rotation=e.rotation))
        if self.host_tier.put(parcel):
            self.cold_spills += 1

    def restore_cold(self, h: int, index: int) -> int | None:
        """Device miss, host hit: pull the spilled page back into a fresh
        pool page, re-register it at its chain position, and return the
        page, or None (no parcel, or no room), in which case the caller
        prefills."""
        if self.host_tier is None or self.arena is None:
            return None
        key = _cold_key(h)
        parcel = self.host_tier.peek(key)
        if parcel is None:
            return None
        meta = parcel.meta
        # same hash => same chain position; a mismatch means corruption
        if meta["index"] != index:
            self.host_tier.take(key)
            return None
        if not self.pool.fits(meta["rotation"] + index, 1):
            return None
        self.host_tier.take(key)
        page = self.pool.alloc(1, start=meta["rotation"] + index)[0]
        self.arena.write_page(page, parcel.data)
        self.register(h, page, parent=meta["parent"], index=index,
                      rotation=meta["rotation"], adopt_ref=True)
        self.cold_restores += 1
        self.host_tier.restores += 1
        self.host_tier.restored_pages += 1
        return page

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        return dict(entries=len(self._entries),
                    idle_pages=self.idle_pages,
                    persistent=self.persistent,
                    registered_pages=self.registered_pages,
                    reused_pages=self.reused_pages,
                    cross_request_hits=self.cross_request_hits,
                    evictions=self.evictions,
                    cold_spills=self.cold_spills,
                    cold_restores=self.cold_restores)
