"""UniMem — the paper's single-form pooled memory, as a page-pool arena.

Port of `repro.core.unimem` for this slice: the host-side control plane
(page tables, free lists, refcounts, pinning) is copied as plain Python,
and the quantized-page contract (`quantize_kv`/`dequantize_kv`) is
rewritten in torch with the same numerics.  The device arena itself is
owned by `serve/kv_cache.py`.

`ShardedUniMemPool` (sharded serving) and `HostTier` (host-DRAM cold
tier) wait for the slices that port those features (ROADMAP.md queue A
items 7 and 12).
"""
from __future__ import annotations

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

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate n pages."""
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

    def fits(self, n: int) -> bool:
        """Would `alloc(n)` succeed right now?"""
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

    def is_shared(self, page: int) -> bool:
        return self._refcount.get(page, 0) > 1

    # ------------------------------------------------------------- stats

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

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
class SequencePageTable:
    """Per-sequence logical->physical page map, length in tokens.
    (The reference's shard `rotation` belongs to the sharded pool and
    waits for it.)"""
    pool: UniMemPool
    pages: list[int] = field(default_factory=list)
    num_tokens: int = 0

    def append_tokens(self, n: int) -> list[int]:
        """Extend by n tokens, allocating pages as needed (copy-on-write is
        the caller's job for shared last pages)."""
        need = self.pool.pages_for(self.num_tokens + n) - len(self.pages)
        new = self.pool.alloc(need) if need > 0 else []
        self.pages.extend(new)
        self.num_tokens += n
        return new

    def fork(self) -> "SequencePageTable":
        """Share the full prefix with a new sequence (no copy)."""
        self.pool.share(self.pages)
        return SequencePageTable(self.pool, list(self.pages), self.num_tokens)

    def cow_last_page(self) -> tuple[int, int] | None:
        """Copy-on-write: swap a SHARED last page for a private one before
        writing into it.  Returns (src, dst) physical ids so the caller
        can copy the device page, or None when nothing is to do."""
        if not self.pages or not self.pool.is_shared(self.pages[-1]):
            return None
        src = self.pages[-1]
        dst = self.pool.alloc(1)[0]
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
