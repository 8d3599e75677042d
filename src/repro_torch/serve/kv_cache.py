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
the arena tensors in place.

Host-tier traffic moves whole pages between the arena and host memory:
`read_pages` gathers them into one pinned host buffer per leaf (the
spill), `prefetch` starts the way back on a side CUDA stream, and
`write_pages` scatters them into fresh pages (the restore).

`paged_write`, `gather_pages` and `paged_decode_attention` are the
reference's multi-layer tool and test entry points over (L, P, page,
hkv, hd) arenas: one token's K/V written through a block table, the
pages gathered back into contiguous rows, and one layer's decode
attention through the plain version of the paged kernel.

The contiguous layout (`layout="contiguous"`) keeps one (max_batch,
max_seq) cache per family instead (`init_cache`); `clear_slot` and
`slot_view` address one batch row of it through each leaf's batch axis,
found in the family's `cache_axes()`.  Admission prefills through the
view of a cleared row, which leaves the cache as the reference's
`insert_slot` of a fresh batch=1 prefill would; `insert_slot` itself
writes a separate batch=1 cache into a row.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.unimem import SequencePageTable, UniMemPool, is_page_leaf
from repro_torch.kernels.paged_attention.ops import paged_decode_attention_plain
from repro_torch.models.config import ModelConfig

# slot axis of the per-slot state leaves ((G, P, max_batch, ...))
STATE_SLOT_AXIS = 2
# the masked score of the reference's kv_cache (its attention oracles')
NEG_INF = -1e30


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
        self.copy_stream = None          # the prefetch's side stream (CUDA)

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

    # ------------------------------------------------- host-tier traffic

    def read_pages(self, pages: list[int]) -> dict:
        """The page leaves of `pages` as host tensors (the spill payload):
        leaf name -> (L, len(pages), ...).  One gather per leaf; on the
        card the gather is copied into a pinned host buffer, and the copy
        waits for the device, so the buffer is whole when this returns.
        The scale leaves of an int8/fp8 arena travel with their pages."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        out = {}
        for name, a in self.kv.items():
            if not is_page_leaf(name):
                continue
            g = a.index_select(1, idx)
            if g.is_cuda:
                host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                host.copy_(g)
                g = host
            out[name] = g
        return out

    def read_page(self, page: int) -> dict:
        """Single-page spill payload: leaf name -> (L, ...) host tensor,
        the shape `write_page` takes back (the prefix store's cold
        parcels, one page each)."""
        return {name: a[:, 0] for name, a in self.read_pages([page]).items()}

    def write_page(self, page: int, data: dict) -> None:
        """Write one page's leaves back into the arena, in place.
        `data` maps leaf name -> (L, ...) tensor (host or device)."""
        for name, a in self.kv.items():
            if name in data:
                a[:, page].copy_(torch.as_tensor(data[name]).to(a.dtype),
                                 non_blocking=True)

    def write_pages(self, pages: list[int], data: dict, ready=None) -> None:
        """Write the leaves of `pages` back into the arena, in place (the
        restore path): `data` maps leaf name -> (L, len(pages), ...), on
        the host (pinned on the card: one host-to-device copy per leaf)
        or already on the device (`prefetch`'s copy, whose `ready` event
        the current stream waits on first).  One `index_copy_` per leaf."""
        cur = None
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if ready is not None:
                cur.wait_event(ready)
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for name, a in self.kv.items():
            if name not in data:
                continue
            src = data[name]
            a.index_copy_(1, idx, src.to(a.device, a.dtype, non_blocking=True))
            if cur is not None and src.is_cuda:
                # a prefetched copy was allocated on the copy stream: keep
                # the allocator from handing it out before this copy runs
                src.record_stream(cur)

    def prefetch(self, data: dict):
        """Start moving a parcel's host payload to the arena's device.  On
        the card the copies run on a side stream (`copy_stream`) from the
        pinned tensors and overlap the compute stream's work; returns the
        device tensors and the event recorded after them, which
        `write_pages(..., ready=)` waits on.  On the CPU a plain copy
        (no event)."""
        if self.device.type != "cuda":
            return {n: t.clone() for n, t in data.items()}, None
        if self.copy_stream is None:
            self.copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            out = {n: t.to(self.device, non_blocking=True)
                   for n, t in data.items()}
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return out, ready

    def cow_for_write(self, seq: SequencePageTable) -> bool:
        """Make `seq`'s last page privately owned before a write lands in
        it, copying the device page when it was shared.  Returns True if
        a copy-on-write happened."""
        moved = seq.cow_last_page()
        if moved is None:
            return False
        self.copy_page(*moved)
        return True


# ----------------------------------------- multi-layer tool entry points

def paged_write(k_arena, v_arena, k_new, v_new, block_table, positions):
    """Write one token's K/V for every sequence into its page, in place.

    k_arena/v_arena: (L, P, page, hkv, hd); k_new/v_new: (L, b, hkv, hd);
    block_table: (b, max_pages) int; positions: (b,) token index being
    written.  Returns the arenas.  Rows are written in batch order, so a
    page two rows share ends with the last row's token, as the
    reference's scan leaves it."""
    page_size = k_arena.shape[2]
    positions = torch.as_tensor(positions, device=k_arena.device).long()
    bt = torch.as_tensor(block_table, device=k_arena.device).long()
    phys = bt.gather(1, (positions // page_size)[:, None])[:, 0]
    offset = positions % page_size
    for arena, new in ((k_arena, k_new), (v_arena, v_new)):
        new = torch.as_tensor(new, device=arena.device)
        for i in range(new.shape[1]):
            arena[:, phys[i], offset[i]] = new[:, i].to(arena.dtype)
    return k_arena, v_arena


def gather_pages(arena, block_table):
    """arena: (L, P, page, hkv, hd); block_table: (b, max_pages)
    -> contiguous copy (L, b, max_pages*page, hkv, hd)."""
    L, _, page, hkv, hd = arena.shape
    b, mp = block_table.shape
    g = arena[:, torch.as_tensor(block_table, device=arena.device).long()]
    return g.reshape(L, b, mp * page, hkv, hd)


def paged_decode_attention(q, k_arena, v_arena, block_table, positions,
                           layer: int):
    """Single-token paged attention for one layer of a multi-layer arena.

    q: (b, hq, hd); arenas (L, P, page, hkv, hd); positions: (b,) index
    of the newest token (inclusive).  Returns (b, hq*hd).  The plain
    version of the paged decode kernel, with the reference oracle's
    score rounding (serving runs the kernel through the model's layers;
    this is the tool and test entry point)."""
    b, hq, hd = q.shape
    dev = k_arena.device
    o = paged_decode_attention_plain(
        q, k_arena[layer], v_arena[layer],
        torch.as_tensor(block_table, device=dev).long(),
        torch.as_tensor(positions, device=dev), round_scores=True)
    return o.reshape(b, hq * hd)


# ------------------------------------------------------- contiguous slots

def batch_axis_index(axes: tuple) -> int:
    """Index of the batch dim in a cache leaf's logical axes tuple."""
    return axes.index("act_batch") if "act_batch" in axes else 0


def clear_slot(cache: dict, slot: int, cache_axes: dict) -> dict:
    """Zero a finished row in place (pos -> 0 keeps it inert in masked
    attention); returns the cache."""
    for name, a in cache.items():
        a.select(batch_axis_index(tuple(cache_axes[name])), slot).zero_()
    return cache


def insert_slot(cache: dict, slot_cache: dict, slot: int,
                cache_axes: dict) -> dict:
    """Write a batch=1 cache into row `slot` of a batched cache, in
    place (each leaf cast to the cache's dtype); returns the cache."""
    for name, a in cache.items():
        i = batch_axis_index(tuple(cache_axes[name]))
        a.select(i, slot).copy_(
            torch.as_tensor(slot_cache[name]).squeeze(i).to(a.dtype))
    return cache


def slot_view(cache: dict, slot: int, cache_axes: dict) -> dict:
    """Row `slot` of a batched cache as a batch=1 cache of VIEWS: a
    prefill run on it writes the row in place.  After `clear_slot`, that
    equals the reference's `insert_slot` of the same prefill run on a
    fresh batch=1 cache, without the full-size batch=1 copy."""
    return {name: a.narrow(batch_axis_index(tuple(cache_axes[name])), slot, 1)
            for name, a in cache.items()}
