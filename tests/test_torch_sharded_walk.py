"""The sharded arena's walk and merge (`repro_torch.models.layers`
`localize_block_table`, `_shard_local_walk`, `run_paged_*_attention`
under `cfg.mem_axis`; `repro_torch.distribution.collectives`
`combine_shard_partials`) against the reference, in-process.

The reference's walk helpers need a bound mesh axis: they run here
under `jax.vmap(..., axis_name="mem")`, one lane per shard.  Per-bank
partials merged by the port equal the reference oracles' full softmax
(`paged_decode_attention_ref`, `paged_prefill_attention_ref`) within
f32 rounding (`TOL`), idle rows and rows with no resident page on a
bank included.  The last test is the port's counterpart of the
reference's `test_sharded_step_collectives_are_summary_sized`: every
tensor handed between a bank and the lead device during a decode and a
prefill step is summary-, query-, token- or table-sized, never
page-sized."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import combine_splits as j_combine
from repro.kernels.paged_attention.ref import paged_decode_attention_ref
from repro.kernels.paged_prefill.ref import paged_prefill_attention_ref
from repro.models import layers as JL
from repro_torch.distribution import collectives as C
from repro_torch.kernels.paged_attention.ops import (
    POS_PAD, paged_decode_attention)
from repro_torch.kernels.paged_prefill.ops import paged_prefill_attention
from repro_torch.models import layers as L

from conftest import TINY
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import jax_family_params, port_cfg

# f32: the merge of n partials sums in another order than one softmax
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype) if dtype else \
        torch.from_numpy(np.array(x))


def _global_table(rng, b, mp, n, pps, idle_rows=(), short_rows=()):
    """A GLOBAL (b, mp) block table as the sharded allocator builds it:
    row i's logical page j from bank (rot_i + j) % n, distinct pages,
    the null id (n * pps) past each row's length; `idle_rows` all null,
    `short_rows` one page only."""
    null = n * pps
    free = {s: list(rng.permutation(pps) + s * pps) for s in range(n)}
    bt = np.full((b, mp), null, np.int32)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        if i in idle_rows:
            continue
        rot = int(rng.integers(n))
        npg = 1 if i in short_rows else int(rng.integers(1, mp + 1))
        for j in range(npg):
            bank = (rot + j) % n
            if not free[bank]:
                break
            bt[i, j] = free[bank].pop()
            lens[i] = j + 1
    return bt, lens


def _ref_walk(bt, page, pps, n):
    """The reference's walk and write tables, one vmap lane per shard."""
    cfg = TINY["dense"].replace(mem_axis="mem")
    bt = jnp.asarray(bt)
    walk = jax.vmap(lambda _: JL._shard_local_walk("mem", bt, page, pps),
                    axis_name="mem")(jnp.arange(n))
    wbt = jax.vmap(lambda _: JL.localize_block_table(cfg, bt, pps),
                   axis_name="mem")(jnp.arange(n))
    return [np.asarray(w) for w in walk], np.asarray(wbt)


@pytest.mark.parametrize("n, mp", [(2, 4), (4, 5), (8, 8), (3, 7)])
def test_shard_walk_and_write_tables_equal_the_reference(n, mp):
    rng = np.random.default_rng(n * 10 + mp)
    pps, page, b = 6, 8, 5
    bt, _ = _global_table(rng, b, mp, n, pps, idle_rows=(1,),
                          short_rows=(3,))
    (lbt, pos), wbt = _ref_walk(bt, page, pps, n)
    cfg = port_cfg(TINY["dense"]).replace(mem_axis="mem")
    tb = torch.from_numpy(bt)
    for s in range(n):
        got_lbt, got_pos = L._shard_local_walk(n, s, tb, page, pps)
        np.testing.assert_array_equal(got_lbt.numpy(), lbt[s])
        np.testing.assert_array_equal(got_pos.numpy(), pos[s])
        np.testing.assert_array_equal(
            L.localize_block_table(cfg, tb, pps, s).numpy(), wbt[s])
    # the idle row is masked on every bank
    assert all((pos[s][1] == POS_PAD).all() for s in range(n))
    # one arena: the table is already physical
    assert L.localize_block_table(port_cfg(TINY["dense"]), tb, pps) is tb


def _strided_halves(bt, page, n=2):
    """The reference's helper (tests/test_sharded_serve.py): shard s
    keeps logical slots s, s+n, ... with their absolute positions."""
    b, mp = bt.shape
    out = []
    for s in range(n):
        cols = np.arange(s, mp, n)
        ppos = np.broadcast_to((cols * page).astype(np.int32)[None, :],
                               (b, len(cols)))
        out.append((bt[:, cols], np.ascontiguousarray(ppos)))
    return out


def _arena(seed=0, b=3, hkv=2, hd=16, page=8, mp=4):
    rng = np.random.default_rng(seed)
    P = b * mp + 1
    k = rng.standard_normal((P, page, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, hkv, hd)).astype(np.float32)
    bt = rng.permutation(P - 1)[:b * mp].reshape(b, mp).astype(np.int32)
    return rng, k, v, bt


@pytest.mark.parametrize("mp, hd", [(4, 16), (5, 16), (4, 160)])
def test_decode_partials_of_strided_shards_merge_to_full_softmax(mp, hd):
    rng, k, v, bt = _arena(mp=mp, hd=hd)
    b, page, hq = 3, 8, 4
    pos = np.asarray([mp * page - 1, 5, 17], np.int32)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    want = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(pos)))
    parts = [paged_decode_attention(_t(q), _t(k), _t(v), _t(lbt), _t(pos),
                                    page_positions=_t(ppos), partials=True)
             for lbt, ppos in _strided_halves(bt, page)]
    m, l, acc = zip(*parts)
    got = C.combine_shard_partials(m, l, acc, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's merge is the reference's combine_splits on the stack, up
    # to an ulp (XLA's exp and fused divide round otherwise than torch's)
    ref_merge = j_combine(*(jnp.stack([jnp.asarray(x[i].numpy())
                                       for x in parts], axis=1)
                            for i in range(3)), b, hq, hd, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_merge),
                               rtol=1e-6, atol=1e-7)


def test_prefill_partials_of_strided_shards_merge_to_full_softmax():
    rng, k, v, bt = _arena(seed=1)
    b, page, hd, hq, c = 3, 8, 16, 4, 8
    start = np.asarray([0, 5, 17], np.int32)
    clen = np.asarray([0, 3, 8], np.int32)        # inert, ragged, full rows
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    want = np.asarray(paged_prefill_attention_ref(
        *map(jnp.asarray, (q, k, v, bt, start, clen))))
    parts = [paged_prefill_attention(_t(q), _t(k), _t(v), _t(lbt), _t(start),
                                     _t(clen), page_positions=_t(ppos),
                                     partials=True)
             for lbt, ppos in _strided_halves(bt, page)]
    m, l, acc = zip(*parts)
    got = C.combine_shard_partials(m, l, acc, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[0] == 0).all()               # the ragged-tail zero contract


def test_pos_pad_sentinel_slots_are_inert():
    """A column naming a REAL page with the POS_PAD position adds
    nothing to the partials."""
    rng, k, v, bt = _arena(seed=2)
    b, mp, page, hd, hq = 3, 4, 8, 16, 4
    pos = _t(np.asarray([mp * page - 1, 5, 17], np.int32))
    q = _t(rng.standard_normal((b, hq, hd)).astype(np.float32))
    ppos = np.broadcast_to((np.arange(mp, dtype=np.int32) * page)[None],
                           (b, mp))
    base = paged_decode_attention(q, _t(k), _t(v), _t(bt), pos,
                                  page_positions=_t(ppos), partials=True)
    bt2 = np.concatenate([bt, bt[:, :1]], axis=1)
    ppos2 = np.concatenate([ppos, np.full((b, 1), POS_PAD, np.int32)], 1)
    got = paged_decode_attention(q, _t(k), _t(v), _t(bt2), pos,
                                 page_positions=_t(ppos2), partials=True)
    for a, g in zip(base, got):
        torch.testing.assert_close(g, a, rtol=1e-6, atol=1e-6)


# --------------------------------- the banked layer against the oracle

def _banked(rng, n, pps, page, hkv, hd, dtype=np.float32):
    """n banks of (pps + 1) slots and the FLAT arena the oracle walks:
    pool page g = bank g // pps, slot g % pps; the flat arena's last page
    (the global null id n * pps) is zeros, as each bank's null slot."""
    banks = rng.standard_normal((n, pps + 1, page, hkv, hd)).astype(dtype)
    banks[:, pps] = 0
    flat = np.concatenate([banks[:, :pps].reshape(n * pps, page, hkv, hd),
                           np.zeros((1, page, hkv, hd), dtype)])
    return banks, flat


@pytest.mark.parametrize("n", [2, 4, 8])
def test_banked_decode_layer_equals_the_oracle_on_the_flat_arena(n):
    rng = np.random.default_rng(100 + n)
    b, mp, page, hq, hkv, hd, pps = 6, 7, 8, 4, 2, 16, 5
    bt, lens = _global_table(rng, b, mp, n, pps, idle_rows=(2,),
                             short_rows=(4,))
    kb, kf = _banked(rng, n, pps, page, hkv, hd)
    vb, vf = _banked(rng, n, pps, page, hkv, hd)
    pos = np.maximum(lens * page - 1 - rng.integers(0, page, b), 0)
    pos = pos.astype(np.int32)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    want = np.asarray(paged_decode_attention_ref(
        *map(jnp.asarray, (q, kf, vf, bt, pos)))).reshape(b, hq * hd)
    cfg = port_cfg(TINY["dense"]).replace(mem_axis="mem")
    got = L.run_paged_decode_attention(
        cfg, _t(q), tuple(_t(x) for x in kb), tuple(_t(x) for x in vb),
        _t(bt), _t(pos))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the idle row comes out as finite zeros, not NaN
    assert torch.isfinite(got).all() and (got[2] == 0).all()


@pytest.mark.parametrize("n", [2, 4])
def test_banked_prefill_layer_equals_the_oracle_on_the_flat_arena(n):
    rng = np.random.default_rng(200 + n)
    b, mp, page, hq, hkv, hd, pps, c = 5, 6, 8, 4, 2, 16, 5, 8
    bt, lens = _global_table(rng, b, mp, n, pps, idle_rows=(1,),
                             short_rows=(3,))
    kb, kf = _banked(rng, n, pps, page, hkv, hd)
    vb, vf = _banked(rng, n, pps, page, hkv, hd)
    clen = np.minimum(lens * page, rng.integers(1, c + 1, b)).astype(np.int32)
    clen[1] = 0
    start = np.maximum(lens * page - clen, 0).astype(np.int32)
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    want = np.asarray(paged_prefill_attention_ref(
        *map(jnp.asarray, (q, kf, vf, bt, start, clen))))
    cfg = port_cfg(TINY["dense"]).replace(mem_axis="mem")
    got = L.run_paged_prefill_attention(
        cfg, _t(q), tuple(_t(x) for x in kb), tuple(_t(x) for x in vb),
        _t(bt), _t(start), _t(clen))
    np.testing.assert_allclose(got.numpy(), want.reshape(b, c, hq * hd),
                               **TOL)
    assert torch.isfinite(got).all() and (got[1] == 0).all()


def test_banked_int8_decode_layer_equals_the_oracle_with_scales():
    """Quantized banks: the scale leaves ride the same per-bank walk."""
    from repro_torch.core.unimem import quantize_kv
    n, b, mp, page, hq, hkv, hd, pps = 4, 4, 6, 8, 4, 2, 16, 4
    rng = np.random.default_rng(7)
    bt, lens = _global_table(rng, b, mp, n, pps, idle_rows=(0,))
    kb, _ = _banked(rng, n, pps, page, hkv, hd)
    vb, _ = _banked(rng, n, pps, page, hkv, hd)
    qk, sk = quantize_kv(_t(kb), torch.int8)
    qv, sv = quantize_kv(_t(vb), torch.int8)

    def flat(x):
        x = x.numpy()
        return np.concatenate([x[:, :pps].reshape(n * pps, *x.shape[2:]),
                               np.zeros((1, *x.shape[2:]), x.dtype)])
    pos = np.maximum(lens * page - 1, 0).astype(np.int32)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    want = np.asarray(paged_decode_attention_ref(
        *map(jnp.asarray, (q, flat(qk), flat(qv), bt, pos)),
        k_scale=jnp.asarray(flat(sk)), v_scale=jnp.asarray(flat(sv))))
    cfg = port_cfg(TINY["dense"]).replace(mem_axis="mem", kv_dtype="int8")
    got = L.run_paged_decode_attention(
        cfg, _t(q), tuple(qk), tuple(qv), _t(bt), _t(pos),
        k_scale=tuple(sk), v_scale=tuple(sv))
    np.testing.assert_allclose(got.numpy(), want.reshape(b, hq * hd), **TOL)


# ------------------------------- the contract: no page crosses the banks

def test_sharded_step_hands_only_summaries_queries_tokens_and_tables(
        monkeypatch):
    """Every tensor `collectives.hand` moves between a bank and the lead
    device during one prefill and one decode step of the sharded engine
    (TINY dense, 4 banks, a geometry where one bank's layer dwarfs a
    summary) is at most a table, a chunk's K/V, the queries or a
    summary, and far below a page bank; every bank hands its summaries
    back at every layer."""
    from repro_torch.launch.mesh import make_mem_mesh
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = TINY["dense"]
    _, params = jax_family_params(cfg)
    pcfg = port_cfg(cfg)
    b, max_seq, page, n = 2, 512, 32, 4
    eng = ServingEngine(pcfg, params, device="cpu", max_batch=b,
                        max_seq=max_seq, page_size=page, prefill_chunk=16,
                        mesh=make_mem_mesh(n, devices=["cpu"]))
    rng = np.random.default_rng(0)
    for uid in range(b):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 9 + uid).astype(np.int32), max_new_tokens=3))
    seen: list[tuple] = []
    real = C.hand

    def record(x, device):
        seen.append(tuple(x.shape))
        return real(x, device)
    monkeypatch.setattr(C, "hand", record)
    eng.step()                                  # admit + prefill + decode
    assert eng.prefill_calls == 1 and eng.decode_calls == 1
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    c = max(s for s in eng.prefill_shapes)[1]
    max_pages = max_seq // page
    allowed = {
        (b, max_pages),                        # the global table, per bank
        (b,), (b, c),                          # positions / start, len, valid
        (b, c, hkv, d), (b, 1, hkv, d),        # the new tokens' K/V
        (b, c, hq, d), (b, hq, d),             # queries and acc summaries
        (b, c, hq), (b, hq),                   # m, l summaries
    }
    assert seen and set(seen) <= allowed, set(seen) - allowed
    # the reference's bounds: below half a bank's layer, and an eighth
    # of the gathered K/V a naive layout would ship
    pps = eng.arena.pages_per_shard
    bank_layer = (pps + 1) * page * hkv * d
    bulk = b * max_seq * hkv * d
    worst = max(int(np.prod(s)) for s in seen)
    assert worst < bank_layer / 2 and worst < bulk / 8, (worst, bank_layer)
    # each layer's walk hands m, l and acc back from every bank: 3 n per
    # layer and step (prefill and decode)
    summaries = [s for s in seen if s in {(b, c, hq), (b, hq), (b, c, hq, d),
                                          (b, hq, d)}]
    assert len(summaries) >= 2 * cfg.num_layers * 3 * n
