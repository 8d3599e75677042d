"""The sharded page arena: UniMem cut into one bank per shard.

Port of `repro.serve.sharded.arena`.  The single pooled arena of
`serve/kv_cache.py`, cut into per-shard banks (DESIGN.md §2): each page
leaf is a TUPLE of n tensors (layers, pps + 1, page, ...), bank s on the
mesh's device s, holding its pps resident pages and its OWN null slot
last (every bank needs a local sink for the writes of tokens other banks
own).  Pool page ids are blocked to match: page g lives in bank g // pps
at local slot g % pps; the engine-visible null sentinel is the global
`num_pages`, which no bank owns, so the walk maps it to every bank's
local null.  On one card all banks are separate allocations on that
card.

Non-page leaves (hybrid's per-slot conv/SSM state) live once, on the
lead device, where the work that is not attention runs; the reference
replicates them on every bank, which gives the same values.

Pages never move between banks.  A copy on write stays in its bank (the
replacement serves the same logical index), and persistent prefix-cache
pages keep the bank of the request that wrote them, so a follower adopts
the donor's rotation and a page restored from the host tier reallocates
at its original `rotation + index` to land back in the same bank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.unimem import ShardedUniMemPool, is_page_leaf
from repro_torch.launch.mesh import MEM_AXIS, MemMesh
from repro_torch.serve.kv_cache import PagedKVArena


@dataclass
class ShardedPagedKVArena(PagedKVArena):
    """A `PagedKVArena` whose page banks live one per shard on `mesh`'s
    devices.  `num_pages` is the GLOBAL pool size (it must divide over
    the shards); `device` is the lead device (the step's, and the state
    leaves')."""
    mesh: MemMesh = None

    def __post_init__(self):
        if self.mesh is None or MEM_AXIS not in self.mesh.axis_names:
            raise ValueError("a sharded arena needs a mem mesh")
        n = self.num_shards
        if self.num_pages % n:
            raise ValueError(f"num_pages {self.num_pages} must divide over "
                             f"{n} shards")
        pps = self.num_pages // n
        if self.kv is None:
            from repro_torch.models import registry
            fam = registry.get_family(self.cfg)
            kv: dict = {}
            for s, dev in enumerate(self.mesh.devices):
                bank = fam.init_paged_cache(self.cfg, pps + 1, self.page_size,
                                            max_batch=self.max_batch,
                                            device=dev)
                for name, a in bank.items():
                    if is_page_leaf(name):
                        kv.setdefault(name, []).append(a)
                    elif s == 0:
                        kv[name] = a.to(self.device)
            self.kv = {name: tuple(a) if is_page_leaf(name) else a
                       for name, a in kv.items()}
        if self.pool is None:
            self.pool = ShardedUniMemPool(self.num_pages, self.page_size,
                                          num_shards=n)
        self.copy_stream = None

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[MEM_AXIS]

    @property
    def pages_per_shard(self) -> int:
        return self.num_pages // self.num_shards

    def _banks(self):
        """(leaf name, per-bank tensors) of the page leaves."""
        return [(n, a) for n, a in self.kv.items() if is_page_leaf(n)]

    def bank_slot(self, page: int) -> tuple[int, int]:
        """(bank, local slot) of pool page id `page`; the null sentinel
        is bank 0's null slot."""
        pps = self.pages_per_shard
        if page == self.null_page:
            return 0, pps
        return page // pps, page % pps

    def phys_slot(self, page: int) -> int:
        """The reference's flat slot of pool page `page`: each bank is
        its pps resident slots plus its null slot."""
        bank, slot = self.bank_slot(page)
        return bank * (self.pages_per_shard + 1) + slot

    @property
    def bytes(self) -> int:
        return sum(self.shard_kv_bytes()) + self.state_bytes

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page across all layers, K/V and scales."""
        return sum(self.shard_kv_bytes()) // (
            self.num_shards * (self.pages_per_shard + 1))

    def shard_kv_bytes(self) -> list[int]:
        """Bytes of the page leaves each bank holds, read from each
        bank's own storage."""
        totals = [0] * self.num_shards
        for _, banks in self._banks():
            for s, a in enumerate(banks):
                totals[s] += a.untyped_storage().nbytes()
        return totals

    def copy_page(self, src: int, dst: int) -> None:
        """Copy on write.  `src` and `dst` serve the same logical index,
        so the strided allocator put them in the SAME bank: the copy
        never leaves it."""
        (bs, ls), (bd, ld) = self.bank_slot(src), self.bank_slot(dst)
        if bs != bd:
            raise ValueError(f"pages {src} and {dst} lie in banks {bs} and "
                             f"{bd}: a page copy never crosses banks")
        for _, banks in self._banks():
            banks[bs][:, ld].copy_(banks[bs][:, ls])

    # ------------------------------------------------- host-tier traffic

    def _columns(self, pages: list[int]):
        """Per bank: (the positions in `pages` it owns, their slots)."""
        cols: dict[int, tuple[list[int], list[int]]] = {}
        for j, p in enumerate(pages):
            bank, slot = self.bank_slot(p)
            c = cols.setdefault(bank, ([], []))
            c[0].append(j)
            c[1].append(slot)
        return cols

    def read_pages(self, pages: list[int]) -> dict:
        """The page leaves of `pages` as host tensors (L, len(pages),
        ...), each bank's pages gathered on its device and copied into
        one host buffer per leaf (pinned when the banks are on the
        card)."""
        cols = self._columns(pages)
        out = {}
        for name, banks in self._banks():
            first = banks[0]
            host = torch.empty((first.shape[0], len(pages), *first.shape[2:]),
                               dtype=first.dtype,
                               pin_memory=first.is_cuda)
            for bank, (pos, slots) in cols.items():
                a = banks[bank]
                idx = torch.tensor(slots, dtype=torch.long, device=a.device)
                host.index_copy_(1, torch.tensor(pos, dtype=torch.long),
                                 a.index_select(1, idx).cpu())
            out[name] = host
        return out

    def write_page(self, page: int, data: dict) -> None:
        """Write one page's leaves ((L, ...) each) into its bank."""
        bank, slot = self.bank_slot(page)
        for name, banks in self._banks():
            if name in data:
                a = banks[bank]
                a[:, slot].copy_(torch.as_tensor(data[name]).to(a.dtype),
                                 non_blocking=True)

    def write_pages(self, pages: list[int], data: dict, ready=None) -> None:
        """Write the leaves of `pages` ((L, len(pages), ...) each, on the
        host or on the lead device after `prefetch`, whose `ready` event
        the lead stream waits on first) into their banks: one
        `index_copy_` per leaf and bank."""
        cur = None
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if ready is not None:
                cur.wait_event(ready)
        cols = self._columns(pages)
        for name, banks in self._banks():
            if name not in data:
                continue
            src = data[name]
            for bank, (pos, slots) in cols.items():
                a = banks[bank]
                part = src.index_select(
                    1, torch.tensor(pos, dtype=torch.long, device=src.device))
                idx = torch.tensor(slots, dtype=torch.long, device=a.device)
                a.index_copy_(1, idx, part.to(a.device, a.dtype,
                                              non_blocking=True))
            if cur is not None and src.is_cuda:
                # a prefetched copy was allocated on the copy stream
                src.record_stream(cur)
