"""The port's persistent prefix store, page pool and host tier
(`repro_torch.serve.prefix_store`, `repro_torch.core.unimem`) held in
lockstep against the reference's over seeded random walks and an
exhaustive walk of the engine's allocator moves, plus the reference's
single-pool law tests (`tests/test_prefix_store.py`,
`tests/test_kv_quant_tier.py`) as cases.  Host logic only: no model."""
from __future__ import annotations

import itertools
from collections import Counter

import numpy as np
import pytest

from repro.core import unimem as J
from repro.serve import prefix_store as JS
from repro_torch.core import unimem as P
from repro_torch.serve import prefix_store as PS


class _ByteArena:
    """Just enough of the paged arena for the store's cold spill path:
    one payload cell per physical page, so a walk can hold restored
    bytes to the bytes that were spilled."""

    def __init__(self):
        self.mem: dict[int, int] = {}

    def read_page(self, page):
        return {"k": self.mem[page]}

    def write_page(self, page, data):
        self.mem[page] = data["k"]


class _Side:
    """One implementation's pool, store, tier and byte arena, driven by
    the engine's allocator moves; `tables` are the live page tables."""

    def __init__(self, unimem, store_mod, *, pool_pages, tier_pages,
                 persistent):
        self.unimem = unimem
        self.pool = unimem.UniMemPool(pool_pages, 1)
        self.tier = unimem.HostTier(tier_pages)
        self.arena = _ByteArena()
        self.store = store_mod.PrefixStore(
            self.pool, persistent=persistent, arena=self.arena,
            host_tier=self.tier)
        self.tables: list[dict] = []

    def admit(self, chain, protect_matched):
        """`_admit_paged`/`_register_prefix` in miniature: match the
        chain head (device hit, else cold restore), then allocate and
        register the tail, evicting idle pages under OOM."""
        pool, store = self.pool, self.store
        pages, refs = [], []
        matching = True
        for i, h in enumerate(chain):
            if matching:
                p = store.page_of(h)
                if p is None:
                    p = store.restore_cold(h, i)
                    if p is not None:
                        assert self.arena.mem[p] == h   # bytes round-tripped
                if p is not None:
                    pool.share([p])
                    store.acquire(h, reuse=True)
                    pages.append(p)
                    refs.append(h)
                    continue
                matching = False
            try:
                p = pool.alloc(1)[0]
            except self.unimem.UniMemOOM:
                if not store.evict(1, protect=set(refs) if protect_matched
                                   else None):
                    break                        # genuine backpressure
                try:
                    p = pool.alloc(1)[0]
                except self.unimem.UniMemOOM:
                    break
            self.arena.mem[p] = h                # "prefill" writes content
            store.register(h, p, parent=chain[i - 1] if i else None,
                           index=i, rotation=0)
            store.acquire(h)
            pages.append(p)
            refs.append(h)
        if pages:
            self.tables.append(dict(pages=pages, refs=refs))
        return list(pages)

    def release(self, k):
        t = self.tables.pop(k % len(self.tables))
        for h in t["refs"]:
            self.store.release(h)
        self.pool.free(t["pages"])

    def fork(self, k):
        t = self.tables[k % len(self.tables)]
        self.pool.share(t["pages"])
        for h in t["refs"]:
            self.store.acquire(h)
        self.tables.append(dict(pages=list(t["pages"]), refs=list(t["refs"])))

    def state(self):
        """Everything the two sides must agree on after every move."""
        s, pool, tier = self.store, self.pool, self.tier
        return dict(
            stats=s.stats(),
            entries=[(h, e.page, e.parent, e.index, e.rotation, e.refs,
                      e.children) for h, e in s._entries.items()],
            by_page=dict(s._by_page), free=list(pool._free),
            refcount=dict(pool._refcount), pinned=set(pool._pinned),
            pool=pool.stats().__dict__, idle=s.idle_pages,
            tier=tier.stats(), resident=tier.resident_pages,
            parcels=[(k, p.num_pages, p.meta)
                     for k, p in tier._parcels.items()],
            tables=self.tables, mem=dict(self.arena.mem))


def _store_laws(side):
    """The reference's cache laws (its `_store_laws`), on one pool."""
    pool, store, tables = side.pool, side.store, side.tables
    free = set(pool._free)
    resident = set(store._by_page)
    assert not (free & resident), "page both free and cache-resident"
    assert {e.page for e in store._entries.values()} == resident
    for p, h in store._by_page.items():
        assert store._entries[h].page == p
    want = Counter(h for t in tables for h in t["refs"])
    got = {h: e.refs for h, e in store._entries.items() if e.refs}
    assert got == dict(want)
    assert pool._pinned == {e.page for e in store._entries.values()
                            if e.refs == 0}
    held = Counter(p for t in tables for p in t["pages"])
    for e in store._entries.values():
        held[e.page] += 1
    assert dict(held) == pool._refcount
    kids = Counter(e.parent for e in store._entries.values()
                   if e.parent in store._entries)
    for h, e in store._entries.items():
        assert e.children == kids.get(h, 0)


def _pair(persistent, pool_pages=6, tier_pages=8):
    kw = dict(pool_pages=pool_pages, tier_pages=tier_pages,
              persistent=persistent)
    return _Side(J, JS, **kw), _Side(P, PS, **kw)


def _both(ref, port, fn):
    """Apply one move to both sides; their results and states must be
    equal afterwards, and the port must hold the cache laws."""
    want, got = fn(ref), fn(port)
    assert got == want
    assert port.state() == ref.state()
    _store_laws(port)
    return got


# chains of chained page hashes: two share a two-page head, one is apart
CHAINS = [(101, 102, 103), (101, 102, 204), (305, 306), (101, 407)]


def _move(op, arg):
    """One move of the walk, as a function of a side."""
    if op == "admit":
        chain = CHAINS[arg % len(CHAINS)]
        return lambda s: s.admit(chain, protect_matched=arg % 2 == 0)
    if op == "retire":
        return lambda s: s.release(arg) if s.tables else None
    if op == "fork":
        return lambda s: s.fork(arg) if s.tables else None
    if op == "evict":
        protect = {h for h in (101, 102, 305) if (arg >> (h % 3)) & 1}
        return lambda s: s.store.evict(1 + arg % 3, protect=protect)
    if op == "restore":
        chain = CHAINS[arg % len(CHAINS)]
        i = (arg // 4) % len(chain)
        # a wrong chain index drops the parcel (the corruption path)
        index = i if arg % 5 else i + 1

        def restore(s):
            p = s.store.restore_cold(chain[i], index)
            if p is not None:            # the page joins no table: release
                s.pool.share([p])        # it through a one-page table
                s.store.acquire(chain[i])
                s.tables.append(dict(pages=[p], refs=[chain[i]]))
            return p
        return restore
    if op == "drop_all":
        return lambda s: s.store.drop_all()
    if op == "put":
        def put(s):
            data = {"k": np.full((1, 1 + arg % 4), arg)}
            return s.tier.put(s.unimem.HostParcel(
                uid=arg % 5, num_pages=1 + arg % 4, data=data,
                meta=dict(tag=arg)))
        return put
    if op == "take":
        return lambda s: getattr(s.tier.take(arg % 5), "meta", None)
    if op == "peek":
        return lambda s: getattr(s.tier.peek(arg % 5), "meta", None)
    if op == "release_unknown":
        return lambda s: s.store.release(999)  # a no-op: no such entry
    raise ValueError(op)


WALK_OPS = ("admit", "admit", "retire", "fork", "evict", "restore",
            "drop_all", "put", "take", "peek", "release_unknown")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("persistent", [True, False])
def test_random_walk_matches_the_reference_after_every_move(persistent,
                                                           seed):
    rng = np.random.default_rng(seed)
    ref, port = _pair(persistent, tier_pages=6)
    for _ in range(80):
        op = WALK_OPS[int(rng.integers(len(WALK_OPS)))]
        _both(ref, port, _move(op, int(rng.integers(64))))
    while port.tables:
        _both(ref, port, lambda s: s.release(0))
    _both(ref, port, lambda s: s.store.drop_all())
    assert port.pool.free_pages == port.pool.num_pages
    assert not port.pool._refcount and not port.pool._pinned


@pytest.mark.parametrize("persistent", [True, False])
def test_exhaustive_walk_matches_the_reference(persistent):
    """Every sequence of 5 moves from {admit, retire, fork, preempt,
    evict} (cold restores ride admit: evicted pages spill to the host
    tier and later admits of the same chain pull them back), port and
    reference in lockstep; draining returns the pool to empty."""
    ops = ("admit", "retire", "fork", "preempt", "evict")
    for seq in itertools.product(ops, repeat=5):
        ref, port = _pair(persistent)
        for step, op in enumerate(seq):
            if op == "admit":
                move = _move("admit", 2 * (step % 3))
            elif op == "retire":
                move = _move("retire", step)
            elif op == "preempt":               # the same reclaim, newest
                move = lambda s: s.release(-1) if s.tables else None
            elif op == "fork":
                move = _move("fork", step)
            else:
                move = lambda s: s.store.evict(2)
            _both(ref, port, move)
        while port.tables:
            _both(ref, port, lambda s: s.release(-1))
        _both(ref, port, lambda s: s.store.drop_all())
        assert port.pool.free_pages == port.pool.num_pages, seq


# ------------------------------------------------- store unit contracts

def test_reregistered_hash_leaves_no_stale_reverse_entry():
    """After a hash is evicted and registered again onto a NEW page, the
    old page id carries no reverse-map entry; registering a resident
    hash again is a no-op returning the resident page."""
    H = 0xBEEF
    pool = P.UniMemPool(4, 2)
    store = PS.PrefixStore(pool, persistent=True)
    p1 = pool.alloc(1)[0]
    store.register(H, p1, parent=None, index=0)
    store.acquire(H)
    store.release(H)                     # donor retires; entry idles
    pool.free([p1])                      # donor's table ref
    assert store.evict(1) == 1 and not pool.is_allocated(p1)
    blocker = pool.alloc(1)[0]
    p2 = pool.alloc(1)[0]
    if p2 == p1:
        blocker, p2 = p2, blocker
    assert p2 != p1
    store.register(H, p2, parent=None, index=0)
    assert store.page_of(H) == p2
    assert store.hash_of(p2) == H and store.hash_of(p1) is None
    p3 = pool.alloc(1)[0]
    pool.free([p3])
    assert store.page_of(H) == p2 and store._by_page == {p2: H}
    p4 = pool.alloc(1)[0]
    assert store.register(H, p4, parent=None, index=0) == p2
    assert len(store) == 1
    pool.free([p4, blocker])


def test_evict_is_lru_leaf_first_and_respects_protect():
    pool = P.UniMemPool(8, 1)
    store = PS.PrefixStore(pool, persistent=True)
    A, B, C = 1, 2, 3
    pa, pb, pc = pool.alloc(3)
    store.register(A, pa, parent=None, index=0)
    store.register(B, pb, parent=A, index=1)
    store.register(C, pc, parent=None, index=0)
    pool.free([pa, pb, pc])              # tables gone; all idle
    assert store.evict(1) == 1           # A is oldest but has a child
    assert A in store and C in store and B not in store
    assert store.evict(1) == 1           # now A is a leaf, older than C
    assert C in store and A not in store
    assert store.evict(1, protect={C}) == 0
    assert C in store
    assert store.evict(1) == 1 and len(store) == 0


def test_cold_spill_restore_roundtrip_and_counters():
    pool = P.UniMemPool(4, 1)
    arena = _ByteArena()
    tier = P.HostTier(4)
    store = PS.PrefixStore(pool, persistent=True, arena=arena,
                           host_tier=tier)
    H = 77
    p = pool.alloc(1)[0]
    arena.mem[p] = H
    store.register(H, p, parent=None, index=0)
    pool.free([p])
    assert store.evict(1) == 1
    assert store.cold_spills == 1 and len(store) == 0
    assert not pool.is_allocated(p)
    q = store.restore_cold(H, 0)
    assert q is not None and pool.is_allocated(q) and arena.mem[q] == H
    assert store.page_of(H) == q and store.cold_restores == 1
    assert tier.restores == 1 and tier.restored_pages == 1
    assert pool.is_pinned(q) and store.entry(H).refs == 0
    assert store.restore_cold(H + 1, 0) is None   # the parcel was consumed


def test_cold_restore_waits_for_room_and_drops_a_misplaced_parcel():
    pool = P.UniMemPool(1, 1)
    arena = _ByteArena()
    store = PS.PrefixStore(pool, persistent=True, arena=arena,
                           host_tier=P.HostTier(4))
    p = pool.alloc(1)[0]
    arena.mem[p] = 5
    store.register(5, p, parent=None, index=2)
    pool.free([p])
    store.evict(1)
    blocker = pool.alloc(1)[0]           # no room: the parcel stays
    assert store.restore_cold(5, 2) is None and ("prefix", 5) in \
        store.host_tier
    pool.free([blocker])
    assert store.restore_cold(5, 1) is None      # wrong chain index
    assert ("prefix", 5) not in store.host_tier
    assert pool.free_pages == 1


def test_a_transient_store_drops_entries_with_their_last_reference():
    pool = P.UniMemPool(2, 1)
    store = PS.PrefixStore(pool)
    p = pool.alloc(1)[0]
    store.register(9, p, parent=None, index=0)
    store.acquire(9)
    assert not pool.is_pinned(p) and pool.pinned_pages == 0
    store.release(9)
    assert 9 not in store and pool.is_allocated(p)   # the table's ref
    pool.free([p])
    assert pool.free_pages == 2
    with pytest.raises(KeyError):
        store.acquire(9)


def test_pool_refuses_to_free_a_pinned_page():
    pool = P.UniMemPool(2, 1)
    p = pool.alloc(1)[0]
    pool.pin(p)
    assert pool.is_pinned(p) and pool.pinned_pages == 1
    with pytest.raises(RuntimeError, match="pinned"):
        pool.free([p])
    assert pool.is_allocated(p)          # the guard fired before mutation
    pool.unpin(p)
    pool.free([p])
    assert pool.free_pages == 2


def test_pinned_and_peak_hot_accounting():
    pool = P.UniMemPool(8, 1)
    a = pool.alloc(4)
    for p in a[:2]:
        pool.pin(p)
    st = pool.stats()
    assert st.pinned_pages == 2 and st.allocated_pages == 4
    assert st.peak_hot_pages == 4 and st.peak_allocated_pages == 4
    pool.alloc(1)                        # hot peak: allocated minus pinned
    assert pool.stats().peak_hot_pages == 4
    for p in a[:2]:
        pool.unpin(p)
    assert pool.stats().peak_hot_pages == 5


# ------------------------------------------------------- HostTier LRU

def _parcel(mod, uid, npages):
    return mod.HostParcel(uid=uid, num_pages=npages,
                          data={"k": np.zeros((1, npages, 2))}, meta={})


@pytest.mark.parametrize("mod", [J, P], ids=["reference", "port"])
def test_host_tier_lru_evicts_oldest_first(mod):
    tier = mod.HostTier(8)
    for uid in range(3):
        assert tier.put(_parcel(mod, uid, 3))   # 9 > 8: uid 0 evicted
    assert 0 not in tier and 1 in tier and 2 in tier
    assert tier.resident_pages == 6
    assert tier.evictions == 1 and tier.evicted_pages == 3
    tier.peek(1)                                # touch: 1 is now MRU
    tier.put(_parcel(mod, 3, 3))                # evicts 2, not 1
    assert 2 not in tier and 1 in tier and 3 in tier


def test_host_tier_refuses_oversize_and_replaces_in_place():
    tier = P.HostTier(4)
    assert not tier.put(_parcel(P, 0, 5))       # alone > capacity
    assert 0 not in tier and tier.resident_pages == 0
    assert tier.put(_parcel(P, 1, 2))
    assert tier.put(_parcel(P, 1, 4))           # replace, not double-count
    assert tier.resident_pages == 4
    assert tier.take(1).num_pages == 4
    assert tier.resident_pages == 0 and tier.take(1) is None
    s = tier.stats()
    assert s["spills"] == 2 and s["peak_resident_pages"] == 4
    ref = J.HostTier(4)
    for uid, n in ((0, 5), (1, 2), (1, 4)):
        ref.put(_parcel(J, uid, n))
    ref.take(1)
    assert s == ref.stats()


def test_stats_have_the_references_keys():
    pool = P.UniMemPool(2, 1)
    ref_pool = J.UniMemPool(2, 1)
    assert (PS.PrefixStore(pool).stats().keys()
            == JS.PrefixStore(ref_pool).stats().keys())
    assert P.HostTier(1).stats() == J.HostTier(1).stats()
    assert pool.stats().__dict__ == ref_pool.stats().__dict__
