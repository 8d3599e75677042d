"""Refcounted prompt-prefix page store over the UniMem pool.

Port of `repro.serve.prefix_store` in its donor-lifetime mode
(`persistent=False`, the reference engine's default): an entry lives
exactly as long as some live page table references it, so a request
shares the full prompt pages of a donor that is still in flight.  The
persistent cache (LRU eviction of idle entries) and the host-tier cold
spill wait for a later slice (ROADMAP.md queue A item 7).

Entries are keyed by the engine's chained page-content hashes.  Each
entry holds its OWN pool reference on top of
the live tables' references, so a registered page can never be freed
behind the store's back; `refs` counts the live tables that lean on the
entry.  A fresh entry is pinned in the pool (allocated, idle) until its
first acquire, exactly as in the reference, so the pool's pinned-page
statistics agree.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.core.unimem import UniMemPool


@dataclass
class PrefixEntry:
    page: int                  # physical page id (store holds one pool ref)
    refs: int = 0              # live page tables referencing via the store


class PrefixStore:
    """Refcounted page-content store (donor lifetime)."""

    def __init__(self, pool: UniMemPool):
        self.pool = pool
        self._entries: "OrderedDict[int, PrefixEntry]" = OrderedDict()
        self._by_page: dict[int, int] = {}
        self.registered_pages = 0
        self.reused_pages = 0          # pages adopted from the store
        self.cross_request_hits = 0    # ... whose donor had fully let go

    # ------------------------------------------------------------ lookup

    def page_of(self, h: int) -> int | None:
        """Resident page for hash h, or None."""
        e = self._entries.get(h)
        return None if e is None else e.page

    # ---------------------------------------------------------- register

    def register(self, h: int, page: int) -> int:
        """Publish `page` (already written with this chain position's KV)
        under hash h; the store takes its own pool reference.  Returns
        the resident page for h (the existing one on re-registration)."""
        e = self._entries.get(h)
        if e is not None:
            self._entries.move_to_end(h)
            return e.page
        if page in self._by_page:
            raise RuntimeError(
                f"page {page} already registered under hash "
                f"{self._by_page[page]:#x}")
        self.pool.share([page])
        self.pool.pin(page)            # idle until first acquire
        e = PrefixEntry(page)
        self._entries[h] = e
        self._by_page[page] = h
        self.registered_pages += 1
        return page

    # ----------------------------------------------------------- refcount

    def acquire(self, h: int, *, reuse: bool = False) -> int:
        """A live page table now references entry h (it also holds its
        own pool ref).  `reuse` marks adoption of a published page for
        the hit counters.  Returns the page."""
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
        """A referencing page table is going away; the entry dies with
        its last reference."""
        e = self._entries.get(h)
        if e is None:
            return
        e.refs -= 1
        if e.refs < 0:
            raise RuntimeError(f"over-release of prefix entry {h:#x}")
        if e.refs == 0:
            self._drop(h)

    def _drop(self, h: int) -> None:
        e = self._entries.pop(h)
        del self._by_page[e.page]
        self.pool.unpin(e.page)
        self.pool.free([e.page])        # the store's own reference

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        return dict(entries=len(self._entries),
                    persistent=False,
                    registered_pages=self.registered_pages,
                    reused_pages=self.reused_pages,
                    cross_request_hits=self.cross_request_hits)
