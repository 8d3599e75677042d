"""The UniMem paged KV arena: device banks + host-side page allocator.

Port of the paged half of `repro.serve.kv_cache`.  ONE device arena of
KV pages is shared by every sequence: K/V shaped
(layers, num_pages + 1, page_size, kv_heads, head_dim); each sequence
maps logical pages to physical pages through a block table.  The LAST
physical slot is the null page: inactive batch rows and past-the-end
table entries point at it, so fused steps over a ragged batch write and
read it harmlessly.  `core/unimem.py` is the allocator; the paged hooks
in `models/transformer.py` and the two kernels are the dataplane.

Any leaf other than the pages (hybrid: "conv"/"ssm") is contiguous
per-ENGINE-slot state with the slot axis at `STATE_SLOT_AXIS`: pages
copy on write, state rows copy on fork.  Page and state copies update
the arena tensors in place.  The contiguous per-slot KV layout waits for
a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.unimem import SequencePageTable, UniMemPool, is_page_leaf
from repro_torch.models.config import ModelConfig

# slot axis of the per-slot state leaves ((G, P, max_batch, ...))
STATE_SLOT_AXIS = 2


@dataclass
class PagedKVArena:
    """Device-side UniMem arena + host-side page allocator.

    `num_pages` is the POOL size; the device arrays carry one extra
    physical slot (`null_page == num_pages`) that is never allocated.
    `max_batch` sizes the per-slot state some families keep beside the
    pages (hybrid conv/SSM rows; batch row i == engine slot i)."""
    cfg: ModelConfig
    num_pages: int
    page_size: int
    device: torch.device
    max_batch: int = 0
    kv: dict = field(default=None, repr=False)   # {"k","v"[,scales]}: (L, P+1, page, ...)
    pool: UniMemPool = field(default=None, repr=False)

    def __post_init__(self):
        if self.kv is None:
            from repro_torch.models import registry
            fam = registry.get_family(self.cfg)
            self.kv = fam.init_paged_cache(self.cfg, self.num_pages + 1,
                                           self.page_size,
                                           max_batch=self.max_batch,
                                           device=self.device)
        if self.pool is None:
            self.pool = UniMemPool(self.num_pages, self.page_size)

    @property
    def null_page(self) -> int:
        return self.num_pages

    @property
    def bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.kv.values())

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page across all layers, K/V, and (when
        quantized) the scale leaves."""
        kv = sum(a.numel() * a.element_size()
                 for n, a in self.kv.items() if is_page_leaf(n))
        return kv // (self.num_pages + 1)

    @property
    def state_bytes(self) -> int:
        """Bytes of the per-slot state (non-page leaves): zero for
        attention-only families, the conv/SSM rows for hybrid."""
        return sum(a.numel() * a.element_size()
                   for n, a in self.kv.items() if not is_page_leaf(n))

    def block_table(self, seqs: list[SequencePageTable],
                    max_pages: int) -> np.ndarray:
        """(b, max_pages) physical page ids, padded with the null page."""
        bt = np.full((len(seqs), max_pages), self.null_page, np.int32)
        for i, s in enumerate(seqs):
            bt[i, :len(s.pages)] = s.pages
        return bt

    def copy_page(self, src: int, dst: int) -> None:
        """Device-side page copy, in place (the COW fixup after
        `SequencePageTable.cow_last_page`).  Only the page leaves move."""
        for name, a in self.kv.items():
            if is_page_leaf(name):
                a[:, dst].copy_(a[:, src])

    def copy_slot_state(self, src_slot: int, dst_slot: int) -> None:
        """Copy the per-slot state rows (hybrid conv/SSM) of one engine
        slot into another, in place: fork's counterpart of page sharing
        for state that cannot be paged."""
        for name, a in self.kv.items():
            if not is_page_leaf(name):
                a.select(STATE_SLOT_AXIS, dst_slot).copy_(
                    a.select(STATE_SLOT_AXIS, src_slot))

    def read_page(self, page: int) -> dict:
        """One page's leaves as host tensors: leaf name -> (L, ...)."""
        return {name: a[:, page].cpu()
                for name, a in self.kv.items() if is_page_leaf(name)}

    def write_page(self, page: int, data: dict) -> None:
        """Write one page's leaves back into the arena, in place.
        `data` maps leaf name -> (L, ...) tensor (host or device)."""
        for name, a in self.kv.items():
            if name in data:
                a[:, page].copy_(torch.as_tensor(data[name]).to(a.dtype))

    def cow_for_write(self, seq: SequencePageTable) -> bool:
        """Make `seq`'s last page privately owned before a write lands in
        it, copying the device page when it was shared.  Returns True if
        a copy-on-write happened."""
        moved = seq.cow_last_page()
        if moved is None:
            return False
        self.copy_page(*moved)
        return True
