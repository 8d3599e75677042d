"""The port's sharded page pool (`repro_torch.core.unimem`
`ShardedUniMemPool`, `SequencePageTable(rotation=)`), the prefix store's
bank-aimed eviction (`PrefixStore.evict(shards=)`) and the engine's
`_rotation_of`, held in lockstep against the reference's over seeded
walks, plus the reference's own sharded pool-law tests as cases
(`tests/test_sharded_serve.py`, `tests/test_prefix_store.py`,
`tests/test_kv_quant_tier.py`).  Host logic only: no model."""
from __future__ import annotations

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import unimem as J
from repro.serve import engine as JE
from repro.serve import prefix_store as JS
from repro_torch.core import unimem as P
from repro_torch.serve import engine as PE
from repro_torch.serve import prefix_store as PS

from test_torch_prefix_store import _ByteArena
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)


# ------------------------------------------------------ lockstep walks

class _Side:
    """One implementation's sharded pool, tier, store and live tables,
    driven by the allocator moves the engine makes."""

    def __init__(self, unimem, store_mod, *, pages, page, shards):
        self.unimem = unimem
        self.pool = unimem.ShardedUniMemPool(pages, page, num_shards=shards)
        self.arena = _ByteArena()
        self.store = store_mod.PrefixStore(
            self.pool, persistent=True, arena=self.arena,
            host_tier=unimem.HostTier(8))
        self.seqs: list = []
        self.raw: list[list[int]] = []
        self.cached = 0

    def do(self, op, a, b):
        """Run one move; returns what the caller saw (pages, an answer,
        or "oom"), never raising on the pool's backpressure."""
        pool, seqs = self.pool, self.seqs
        try:
            if op == "new":
                s = self.unimem.SequencePageTable(pool, rotation=a)
                seqs.append(s)
                return s.append_tokens(1 + b)
            if op == "grow" and seqs:
                return seqs[a % len(seqs)].append_tokens(1 + b)
            if op == "fork" and seqs:
                seqs.append(seqs[a % len(seqs)].fork())
                return list(seqs[-1].pages)
            if op == "cow" and seqs:
                return seqs[a % len(seqs)].cow_last_page()
            if op == "truncate" and seqs:
                s = seqs[a % len(seqs)]
                return s.truncate(s.num_tokens * (b % 4) // 4)
            if op == "release" and seqs:
                seqs.pop(a % len(seqs)).release()
                return None
            if op == "raw":
                self.raw.append(pool.alloc(1 + b % 3))
                return self.raw[-1]
            if op == "unraw" and self.raw:
                pool.free(self.raw.pop(a % len(self.raw)))
                return None
            if op == "fits":
                return pool.fits(a, 1 + b)
            if op == "cache":
                # a retired donor's page cached at its rotation, pinned idle
                h = 1000 + self.cached
                self.cached += 1
                p = pool.alloc(1, start=a + b)[0]
                self.arena.mem[p] = h
                self.store.register(h, p, parent=None, index=b,
                                    rotation=a)
                self.store.acquire(h)
                self.store.release(h)
                pool.free([p])
                return p
            if op == "evict":
                shards = {a % pool.num_shards, b % pool.num_shards}
                return self.store.evict(1 + b % 2, shards=shards)
            if op == "restore":
                keys = sorted(k[1] for k in self.store.host_tier._parcels)
                if not keys:
                    return None
                h = keys[a % len(keys)]
                meta = self.store.host_tier.peek(("prefix", h)).meta
                return self.store.restore_cold(h, meta["index"])
        except self.unimem.UniMemOOM:
            return "oom"
        return None

    def state(self):
        pool, store = self.pool, self.store
        return dict(free=list(pool._free), refcount=dict(pool._refcount),
                    pinned=set(pool._pinned), stats=pool.stats().__dict__,
                    shards=pool.shard_stats(),
                    seqs=[(s.pages, s.num_tokens, s.rotation)
                          for s in self.seqs],
                    raw=self.raw,
                    entries=[(h, e.page, e.parent, e.index, e.rotation,
                              e.refs, e.children)
                             for h, e in store._entries.items()],
                    store=store.stats(), mem=dict(self.arena.mem))


# growth moves twice, so that every walk meets per-bank backpressure
OPS = ("new", "grow", "new", "grow", "fork", "cow", "truncate", "release",
       "raw", "unraw", "fits", "cache", "evict", "restore")


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pool_and_store_walk_in_lockstep_with_the_reference(
        seed, shards):
    rng = np.random.default_rng(seed)
    kw = dict(pages=3 * shards, page=4, shards=shards)
    ref, port = _Side(J, JS, **kw), _Side(P, PS, **kw)
    ooms = 0
    for _ in range(60):
        op = OPS[int(rng.integers(len(OPS)))]
        a, b = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        want, got = ref.do(op, a, b), port.do(op, a, b)
        ooms += want == "oom"
        assert got == want, (op, a, b)
        assert port.state() == ref.state(), (op, a, b)
    while ref.seqs:
        ref.seqs.pop().release()
        port.seqs.pop().release()
    assert port.state() == ref.state()
    assert ooms > 0                # the walk met per-bank backpressure


# --------------------------------------- the reference's law tests

@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_sharded_pool_strides_sequences_across_banks(unimem):
    pool = unimem.ShardedUniMemPool(16, 4, num_shards=4)
    seq = unimem.SequencePageTable(pool)
    seq.append_tokens(13)                      # 4 pages
    assert [pool.shard_of(p) for p in seq.pages] == [0, 1, 2, 3]
    seq.append_tokens(4)                       # logical page 4 -> shard 0
    assert pool.shard_of(seq.pages[4]) == 0
    seq.release()
    assert pool.free_pages == 16


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_sharded_pool_per_bank_oom_and_fits(unimem):
    pool = unimem.ShardedUniMemPool(8, 4, num_shards=4)    # 2 pages a bank
    a, b = unimem.SequencePageTable(pool), unimem.SequencePageTable(pool)
    a.append_tokens(8)
    b.append_tokens(8)
    c = unimem.SequencePageTable(pool)
    assert not pool.fits(0, 1)                 # bank 0 is full...
    assert pool.fits(2, 1)                     # ...bank 2 is empty
    free_before = pool.free_pages
    with pytest.raises(unimem.UniMemOOM):
        c.append_tokens(1)                     # wants bank 0
    assert pool.free_pages == free_before      # OOM never mutates
    assert c.num_tokens == 0 and not c.pages
    held = a.pages + b.pages
    assert len(set(held)) + pool.free_pages == pool.num_pages
    a.release()
    b.release()
    assert pool.free_pages == 8


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_sharded_pool_cow_and_fork_stay_on_shard(unimem):
    pool = unimem.ShardedUniMemPool(12, 4, num_shards=4)
    seq = unimem.SequencePageTable(pool)
    seq.append_tokens(10)                      # 3 pages on shards 0, 1, 2
    fork = seq.fork()
    src, dst = seq.cow_last_page()
    assert pool.shard_of(src) == pool.shard_of(dst) == 2
    assert fork.pages[2] == src                # the peer keeps the original
    seq.release()
    fork.release()
    assert pool.free_pages == 12


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_sharded_pool_untracked_alloc_spreads_least_loaded(unimem):
    pool = unimem.ShardedUniMemPool(8, 4, num_shards=4)
    pages = pool.alloc(4)                      # no logical index: spread
    assert sorted(pool.shard_of(p) for p in pages) == [0, 1, 2, 3]
    assert all(s["allocated_pages"] == 1 for s in pool.shard_stats())
    pool.free(pages)


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_rotation_spreads_page0_of_short_sequences_across_banks(unimem):
    n = 8
    flat = unimem.ShardedUniMemPool(64, 4, num_shards=n)
    for _ in range(n):
        unimem.SequencePageTable(flat).append_tokens(4)
    peaks = [d["peak_allocated_pages"] for d in flat.shard_stats()]
    assert peaks[0] == n and sum(peaks[1:]) == 0
    rot = unimem.ShardedUniMemPool(64, 4, num_shards=n)
    seqs = [unimem.SequencePageTable(rot, rotation=i % n) for i in range(n)]
    for s in seqs:
        s.append_tokens(4)
    assert [d["peak_allocated_pages"] for d in rot.shard_stats()] == [1] * n
    seqs[3].append_tokens(8)                   # logical pages 1, 2
    assert [rot.shard_of(p) for p in seqs[3].pages] == [3, 4, 5]
    f = seqs[3].fork()
    src, dst = seqs[3].cow_last_page()
    assert rot.shard_of(src) == rot.shard_of(dst) == 5
    f.release()


@pytest.mark.parametrize("unimem, store_mod", [(J, JS), (P, PS)],
                         ids=["reference", "port"])
def test_evict_targets_requested_shards_first(unimem, store_mod):
    pool = unimem.ShardedUniMemPool(6, 1, num_shards=3)
    store = store_mod.PrefixStore(pool, persistent=True)
    pages = {}
    for i, h in enumerate((10, 11, 12)):       # one entry per bank
        p = pool.alloc(1, start=i)[0]
        store.register(h, p, parent=None, index=0, rotation=0)
        pages[h] = p
        pool.free([p])
    assert store.evict(1, shards={pool.shard_of(pages[11])}) == 1
    assert 11 not in store and 10 in store and 12 in store


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_pinned_and_peak_hot_accounting(unimem):
    pool = unimem.ShardedUniMemPool(8, 1, num_shards=2)
    a = pool.alloc(4, start=0)
    for p in a[:2]:
        pool.pin(p)
    st = pool.stats()
    assert st.pinned_pages == 2 and st.allocated_pages == 4
    assert st.peak_hot_pages <= st.peak_allocated_pages
    assert sum(d["pinned_pages"] for d in pool.shard_stats()) == 2
    for p in a[:2]:
        pool.unpin(p)
    pool.free(a)


@pytest.mark.parametrize("unimem", [J, P], ids=["reference", "port"])
def test_sharded_fits_exact_under_preempt_spill_churn(unimem):
    pool = unimem.ShardedUniMemPool(16, 8, num_shards=4)
    seqs = [unimem.SequencePageTable(pool, rotation=r) for r in (0, 1, 2)]
    for s in seqs:
        s.append_tokens(4 * 8)                 # 4 pages each, strided
    assert [d["allocated_pages"] for d in pool.shard_stats()] == [3] * 4
    assert pool.fits(0, 4) and not pool.fits(0, 5)
    victim = seqs.pop(1)
    rot = victim.rotation
    victim.release()
    assert pool.fits(rot, 4)
    restored = unimem.SequencePageTable(pool, rotation=rot)
    restored.append_tokens(4 * 8)
    assert sorted(p // pool.pages_per_shard
                  for p in restored.pages) == [0, 1, 2, 3]
    assert all(d["peak_allocated_pages"] <= pool.pages_per_shard
               for d in pool.shard_stats())
    assert pool.fits(3, 4)
    unimem.SequencePageTable(pool, rotation=3).append_tokens(4 * 8)
    assert not pool.fits(0, 1) and pool.free_pages == 0
    with pytest.raises(unimem.UniMemOOM):
        unimem.SequencePageTable(pool, rotation=0).append_tokens(1)


def _store_laws(pool, store, tables):
    """The reference's four cache laws (tests/test_prefix_store.py)."""
    assert not (set(pool._free) & set(store._by_page))
    for p, h in store._by_page.items():
        assert store._entries[h].page == p
    live = {}
    for t in tables:
        for h in t["refs"]:
            live[h] = live.get(h, 0) + 1
    assert {h: e.refs for h, e in store._entries.items() if e.refs} == live
    assert pool._pinned == {e.page for e in store._entries.values()
                            if e.refs == 0}


def _admit(unimem, pool, store, arena, tables, chain):
    pages, refs = [], []
    matching = True
    for i, h in enumerate(chain):
        if matching:
            p = store.page_of(h)
            if p is None:
                p = store.restore_cold(h, i)
            if p is not None:
                pool.share([p])
                store.acquire(h, reuse=True)
                pages.append(p)
                refs.append(h)
                continue
            matching = False
        try:
            p = pool.alloc(1, start=i)[0]
        except unimem.UniMemOOM:
            if not store.evict(1, shards={i % pool.num_shards}) \
                    and not store.evict(1):
                break
            try:
                p = pool.alloc(1, start=i)[0]
            except unimem.UniMemOOM:
                break
        arena.mem[p] = h
        store.register(h, p, parent=chain[i - 1] if i else None, index=i,
                       rotation=0)
        store.acquire(h)
        pages.append(p)
        refs.append(h)
    if pages:
        tables.append(dict(pages=pages, refs=refs))


def _release(pool, store, t):
    for h in t["refs"]:
        store.release(h)
    pool.free(t["pages"])


@pytest.mark.parametrize("persistent", [True, False])
def test_store_exhaustive_walk_holds_cache_laws_on_a_sharded_pool(persistent):
    """Every 5-move sequence of {admit, retire, fork, preempt, evict} on
    a 3-bank pool, the port beside the reference: the cache laws hold in
    every state, the two agree after every move, and draining empties
    the pool."""
    OPS5 = ("admit", "retire", "fork", "preempt", "evict")
    CHAINS = [(101, 102, 103), (101, 102, 204), (305, 306)]

    def make(unimem, store_mod):
        pool = unimem.ShardedUniMemPool(6, 1, num_shards=3)
        arena = _ByteArena()
        store = store_mod.PrefixStore(pool, persistent=persistent,
                                      arena=arena,
                                      host_tier=unimem.HostTier(8))
        return unimem, pool, store, arena, []

    for seq in itertools.product(OPS5, repeat=5):
        sides = [make(J, JS), make(P, PS)]
        for step, op in enumerate(seq):
            for unimem, pool, store, arena, tables in sides:
                if op == "admit":
                    _admit(unimem, pool, store, arena, tables,
                           CHAINS[step % len(CHAINS)])
                elif op == "retire" and tables:
                    _release(pool, store, tables.pop(step % len(tables)))
                elif op == "preempt" and tables:
                    _release(pool, store, tables.pop())
                elif op == "fork" and tables:
                    t = tables[step % len(tables)]
                    pool.share(t["pages"])
                    for h in t["refs"]:
                        store.acquire(h)
                    tables.append(dict(pages=list(t["pages"]),
                                       refs=list(t["refs"])))
                elif op == "evict":
                    store.evict(2, shards={step % 3})
                _store_laws(pool, store, tables)
            (_, rp, rs, ra, rt), (_, pp, ps, pa, pt) = sides
            assert (list(pp._free), pp.shard_stats(), ps.stats(), pt,
                    pa.mem) == (list(rp._free), rp.shard_stats(),
                                rs.stats(), rt, ra.mem), seq
        for _, pool, store, _, tables in sides:
            while tables:
                _release(pool, store, tables.pop())
            store.drop_all()
            assert pool.free_pages == pool.num_pages


# ------------------------------------------------- the engine's rotation

@pytest.mark.parametrize("shards", [1, 4, 8])
def test_rotation_of_equals_the_reference(shards):
    """`_rotation_of` (crc32 of the first page's content, mod the bank
    count) on the same requests, vlm image rows included."""
    rng = np.random.default_rng(shards)

    def holder(unimem):
        pool = (unimem.ShardedUniMemPool(8 * shards, 8, num_shards=shards)
                if shards > 1 else unimem.UniMemPool(8, 8))
        return SimpleNamespace(pool=pool, page_size=8)

    jh, ph = holder(J), holder(P)
    for i in range(24):
        prompt = rng.integers(0, 128, int(rng.integers(1, 30))
                              ).astype(np.int32)
        pe = (rng.standard_normal((int(rng.integers(1, 12)), 4))
              .astype(np.float32) if i % 3 == 0 else None)
        want = JE.ServingEngine._rotation_of(
            jh, JE.Request(uid=i, prompt=prompt, patch_embeds=pe))
        got = PE.ServingEngine._rotation_of(
            ph, PE.Request(uid=i, prompt=prompt, patch_embeds=pe))
        assert got == want
