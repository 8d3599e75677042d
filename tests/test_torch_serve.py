"""PyTorch port vs the JAX reference: the paged serving slice.

The port's transformer step, page pool, engine and `LLMServer` are held
against `repro` on the CPU at TINY["dense"] f32 — the paged step's
logits and arena within atol = rtol = 1e-5, greedy streams
byte-identical, pool statistics equal.  The reference engine runs with
its default `attention_impl="flash_xla"` (its XLA paged oracles)."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY
from repro.core.unimem import SequencePageTable as JaxTable
from repro.core.unimem import UniMemOOM as JaxOOM
from repro.core.unimem import UniMemPool as JaxPool
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro.serve import ServingEngine as JaxEngine
from repro.serve.api import LLMServer as JaxServer
from repro.serve.engine import FinishEvent as JaxFinish
from repro.serve.engine import Request as JaxRequest
from repro.serve.kv_cache import PagedKVArena as JaxArena
from repro.serve.sampling import SamplingParams as JaxSP
from repro.serve.sampling import sample as jax_sample
from repro.serve.sampling import state_for_slots as jax_state
from repro_torch.core.unimem import SequencePageTable, UniMemOOM, UniMemPool
from repro_torch.models import transformer as PT
from repro_torch.serve.api import LLMServer
from repro_torch.serve.engine import FinishEvent, Request, ServingEngine
from repro_torch.serve import prng
from repro_torch.serve.kv_cache import PagedKVArena
from repro_torch.serve.sampling import (SamplingParams, device_knobs,
                                        filter_logits, greedy_state,
                                        host_knobs, sample_tokens,
                                        state_for_slots)
from repro_torch.serve.serve_step import to_device
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

F32 = dict(atol=1e-5, rtol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dense():
    cfg = TINY["dense"]
    params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    return cfg, params, port_params(params, cfg)


# ------------------------------------------------------ transformer step

def test_paged_step_logits_and_arena_match_reference(dense):
    """Two prefill chunks (the second at a nonzero start, with a ragged
    row, an inert row and a past-the-end bucket tail) and one decode
    step with an inactive row: logits of live rows and every non-null
    arena slot agree."""
    cfg, jp, pp = dense
    pc = port_cfg(cfg)
    page, P, mp, b = 8, 16, 8, 4
    rng = np.random.default_rng(0)
    bt = np.full((b, mp), P, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    for i, n in enumerate((3, 2, 4, 0)):
        bt[i, :n] = perm[4 * i:4 * i + n]
    j_arena = JT.init_paged_cache(cfg, P + 1, page)
    t_arena = PT.init_paged_cache(pc, P + 1, page, device="cpu")
    steps = [(np.array([0, 0, 0, 0]), np.array([8, 5, 8, 0])),
             (np.array([8, 5, 8, 0]), np.array([8, 3, 0, 0]))]
    for start, clen in steps:
        tokens = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
        j_arena, jl = JT.paged_prefill(
            jp, cfg, {"tokens": jnp.asarray(tokens)}, j_arena,
            jnp.asarray(bt), jnp.asarray(start, jnp.int32),
            jnp.asarray(clen, jnp.int32))
        t_arena, tl = PT.paged_prefill(
            pp, pc, {"tokens": torch.from_numpy(tokens)}, t_arena,
            torch.from_numpy(bt), torch.from_numpy(start.astype(np.int32)),
            torch.from_numpy(clen.astype(np.int32)))
        live = clen > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **F32)
    positions = np.array([16, 8, 8, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    j_arena, jl = JT.paged_decode_step(jp, cfg, j_arena, jnp.asarray(bt),
                                       jnp.asarray(positions),
                                       jnp.asarray(tokens))
    t_arena, tl = PT.paged_decode_step(pp, pc, t_arena, torch.from_numpy(bt),
                                       torch.from_numpy(positions),
                                       torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **F32)
    for name in ("k", "v"):                       # the null slot is garbage
        np.testing.assert_allclose(t_arena[name][:, :P].numpy(),
                                   np.asarray(j_arena[name])[:, :P], **F32)
    written = (t_arena["k"][:, :P] != 0).any(dim=(0, 2, 3, 4))
    # rows hold 17, 9 and 9 tokens: 3 + 2 + 2 pages; bucket tails and the
    # inert row went to the null slot, not into row 2's spare pages
    assert int(written.sum()) == 7


# ------------------------------------------------------------------ pool

def _pool_walk(pool_cls, table_cls, oom_cls, seed):
    rng = np.random.default_rng(seed)
    pool = pool_cls(12, 4)
    tables, log = [], []
    for _ in range(400):
        op = int(rng.integers(0, 6))
        k = int(rng.integers(0, 1 << 30))
        n = int(rng.integers(1, 9))
        try:
            if op == 0 or not tables:
                t = table_cls(pool)
                tables.append(t)
                t.append_tokens(n)
                out = list(t.pages)
            elif op == 1:
                t = tables[k % len(tables)]
                out = t.append_tokens(n)
            elif op == 2:
                tables.append(tables[k % len(tables)].fork())
                out = list(tables[-1].pages)
            elif op == 3:
                out = tables[k % len(tables)].cow_last_page()
            elif op == 4:
                t = tables[k % len(tables)]
                out = t.truncate(min(n, t.num_tokens))
            else:
                tables.pop(k % len(tables)).release()
                out = None
        except oom_cls:
            out = "oom"
        log.append((op, out, pool.stats().__dict__,
                    [(list(t.pages), t.num_tokens) for t in tables]))
    return log


def test_pool_walk_matches_reference():
    want = _pool_walk(JaxPool, JaxTable, JaxOOM, seed=1)
    got = _pool_walk(UniMemPool, SequencePageTable, UniMemOOM, seed=1)
    assert got == want
    assert any(out == "oom" for _, out, _, _ in got)


# ----------------------------------------------------------------- arena

@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_arena_geometry_tables_and_page_copies_match_reference(kv_dtype):
    cfg = TINY["dense"].replace(kv_dtype=kv_dtype)
    ja = JaxArena(cfg, num_pages=8, page_size=4)
    ta = PagedKVArena(port_cfg(cfg), num_pages=8, page_size=4, device="cpu")
    assert (ta.bytes, ta.page_bytes, ta.null_page) == (
        ja.bytes, ja.page_bytes, ja.null_page)
    assert sorted(ta.kv) == sorted(ja.kv)
    js, ts = [JaxTable(ja.pool) for _ in range(2)], \
        [SequencePageTable(ta.pool) for _ in range(2)]
    for j, t, n in zip(js, ts, (6, 9)):
        j.append_tokens(n)
        t.append_tokens(n)
    np.testing.assert_array_equal(ta.block_table(ts, 5), ja.block_table(js, 5))

    # copy-on-write after a fork copies the shared last page's bytes, and
    # read_page / write_page round-trip one page's leaves
    last = ts[0].pages[-1]
    for name, a in ta.kv.items():
        a[:, last] = torch.arange(a[:, last].numel()).reshape(
            a[:, last].shape).to(a.dtype)
    child = ts[0].fork()
    assert ta.cow_for_write(child) and child.pages[-1] != last
    assert not ta.cow_for_write(ts[0])            # now exclusively owned
    page = ta.read_page(last)
    assert set(page) == set(ta.kv)
    for name, a in ta.kv.items():
        assert torch.equal(a[:, child.pages[-1]], a[:, last])
    spare = ta.pool.alloc(1)[0]
    ta.write_page(spare, page)
    for name, a in ta.kv.items():
        assert torch.equal(a[:, spare], page[name])


# ---------------------------------------------------------------- engine

STAT_KEYS = ("steps", "tokens_out", "prefill_tokens", "admitted",
             "preemptions", "cancellations", "peak_kv_bytes",
             "prefill_buckets", "prefill_shapes")


def _events(evs):
    out = []
    for e in evs:
        if isinstance(e, (FinishEvent, JaxFinish)):
            out.append(("finish", e.uid, e.reason, tuple(e.result.tokens)))
        else:
            out.append(("token", e.uid, e.token, e.index))
    return out


def image_rows(cfg, uid):
    """A vlm request's seeded image: image `uid % 2`, so a scenario holds
    requests under one image and under another."""
    rng = np.random.default_rng(1000 + uid % 2)
    return rng.standard_normal(
        (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)


def with_images(request_cls, cfg):
    """`request_cls`, giving each request of a patch-frontend config its
    `image_rows`; unchanged for every other config."""
    if cfg.frontend != "patch":
        return request_cls
    return lambda uid, **kw: request_cls(
        uid=uid, patch_embeds=image_rows(cfg, uid), **kw)


def _drive(engine, request_cls, script):
    """Run a scripted scenario: `script` maps a step number to actions
    taken before that step ("submit", "fork", "cancel"); a vlm's
    requests carry `image_rows`."""
    request_cls = with_images(request_cls, engine.cfg)
    log = []
    step = 0
    while True:
        for act in script.get(step, ()):
            if act[0] == "submit":
                _, uid, prompt, n = act
                engine.submit(request_cls(uid=uid, prompt=prompt,
                                          max_new_tokens=n))
            elif act[0] == "fork":
                engine.fork(act[1], act[2])
            elif act[0] == "cancel":
                log.append(("cancel", act[1], engine.cancel(act[1])))
        if not (engine.pending or engine.slots) and step > max(script):
            break
        engine.step()
        log.extend(_events(engine.events()))
        step += 1
        assert step < 500
    st = engine.stats()
    stats = {k: st[k] for k in STAT_KEYS}
    stats["pool"] = dict(st["pool"])
    stats["prefix_store"] = {k: st["prefix_store"][k] for k in
                             ("entries", "registered_pages", "reused_pages",
                              "cross_request_hits")}
    if "speculative" in st:                        # speculate_k > 0
        stats["speculative"] = st["speculative"]
    return log, stats


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _scenario(name, vocab):
    if name == "chunked":
        ps = _prompts(2, (40, 13, 27, 9, 33, 21), vocab)
        # co-prefills page 0 with request 0, then adopts its written pages
        ps[3] = np.concatenate([ps[0][:24], ps[3]])
        ps[4] = np.concatenate([ps[0][:32], ps[4][:5]])
        kw = dict(max_batch=4, max_seq=64, page_size=8, prefill_chunk=8)
        script = {0: [("submit", i, p, 6) for i, p in enumerate(ps[:4])],
                  3: [("submit", 4 + i, p, 5) for i, p in enumerate(ps[4:])]}
    elif name == "preempt":
        ps = _prompts(3, (30, 28, 25, 20), vocab)
        kw = dict(max_batch=4, max_seq=64, page_size=8, pool_pages=9,
                  prefill_chunk=16)
        script = {0: [("submit", i, p, 8) for i, p in enumerate(ps)]}
    elif name == "fork_cancel_budget":
        ps = _prompts(4, (20, 35, 11, 17), vocab)
        kw = dict(max_batch=4, max_seq=64, page_size=8, prefill_chunk=16,
                  prefill_decode_ratio=0.5, tick_token_budget=12)
        script = {0: [("submit", i, p, 7) for i, p in enumerate(ps[:3])],
                  4: [("fork", 0, 10)],
                  5: [("cancel", 1), ("submit", 3, ps[3], 6)],
                  7: [("cancel", 3), ("fork", 10, 11)]}
    elif name == "watermark":
        ps = _prompts(5, (20, 20, 20), vocab)
        kw = dict(max_batch=4, max_seq=64, page_size=8, pool_pages=16,
                  high_watermark=0.5)
        script = {0: [("submit", i, p, 6) for i, p in enumerate(ps)]}
    return kw, script


@pytest.mark.parametrize("name", ["chunked", "preempt", "fork_cancel_budget",
                                  "watermark"])
def test_engine_streams_and_stats_match_reference(dense, name):
    cfg, jp, pp = dense
    kw, script = _scenario(name, cfg.vocab_size)
    want = _drive(JaxEngine(cfg, jp, **kw), JaxRequest, script)
    got = _drive(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
                 Request, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]
    if name in ("preempt", "watermark"):
        assert got[1]["preemptions"] > 0
    if name == "chunked":
        assert got[1]["prefix_store"]["reused_pages"] > 0
    assert got[1]["pool"]["allocated_pages"] == 0


def test_llm_server_generate_stream_fork_match_reference(dense):
    cfg, jp, pp = dense
    ps = _prompts(6, (19, 30, 7), cfg.vocab_size)

    def serve(server_cls, sp_cls, params, **kw):
        server = server_cls(cfg if server_cls is JaxServer else port_cfg(cfg),
                            params, max_batch=4, max_seq=64, page_size=8,
                            prefill_chunk=16, **kw)
        streams = [server.generate(p, sp_cls(max_new_tokens=6, stop=(5,)))
                   for p in ps]
        first = [next(streams[0]) for _ in range(2)]
        child = streams[0].fork(sp_cls(max_new_tokens=9))
        cancelled = streams[1].cancel()
        server.run()
        out = [(s.uid, s.tokens, s.drain().finish_reason)
               for s in streams + [child]]
        return [(e.token, e.index) for e in first], out, \
            (cancelled.tokens, cancelled.finish_reason), \
            server.stats["pool"]["allocated_pages"]

    want = serve(JaxServer, JaxSP, jp)
    got = serve(LLMServer, SamplingParams, pp, device="cpu")
    assert got == want
    assert got[2][1] == "cancelled" and got[3] == 0


def test_engine_run_returns_the_reference_results(dense):
    cfg, jp, pp = dense
    ps = _prompts(11, (9, 22, 14), cfg.vocab_size)

    def run(engine, request_cls):
        for i, p in enumerate(ps):
            engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=5))
        return [(r.uid, r.tokens, r.finish_reason) for r in engine.run()]

    kw = dict(max_batch=2, max_seq=32, page_size=4)
    assert run(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
               Request) == run(JaxEngine(cfg, jp, **kw), JaxRequest)


# -------------------------------------------------------------- sampling

def _np_kept(logits, temperature, top_k, top_p):
    """numpy transcription of the reference's top-k / top-p masking
    (repro/serve/sampling.py:176-193): the kept set of each row."""
    b, V = logits.shape
    scaled = logits / np.maximum(temperature, 1e-6)[:, None]
    desc = -np.sort(-scaled, axis=-1)
    k_eff = np.where(top_k > 0, top_k, V)
    kth = np.take_along_axis(desc, np.clip(k_eff[:, None] - 1, 0, V - 1), 1)
    scaled = np.where(scaled < kth, -1e30, scaled)
    e = np.exp(scaled - scaled.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    psort = -np.sort(-probs, axis=-1)
    keep = np.cumsum(psort, -1) - psort < top_p[:, None]
    thr = np.min(np.where(keep, psort, np.inf), -1, keepdims=True)
    scaled = np.where((top_p < 1.0)[:, None] & (probs < thr), -1e30, scaled)
    return scaled > -1e29


def _sampled_state(mod_state, mod_sp, b):
    configs = [mod_sp(temperature=0.7, top_k=5, seed=3),
               mod_sp(temperature=1.3, top_p=0.8, seed=4),
               mod_sp(temperature=0.9, top_k=12, top_p=0.6, seed=5),
               mod_sp()]                                  # greedy row
    return mod_state(b, [(i, c, 2 * i) for i, c in enumerate(configs)])


def test_filtered_set_matches_numpy_transcription():
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
    st = _sampled_state(state_for_slots, SamplingParams, 4)
    kept = filter_logits(torch.from_numpy(logits), st).numpy() > -1e29
    want = _np_kept(logits.astype(np.float64), st.temperature, st.top_k,
                    st.top_p)
    np.testing.assert_array_equal(kept[:3], want[:3])
    assert kept[0].sum() == 5
    greedy = sample_tokens(torch.from_numpy(logits), greedy_state(4))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_sampling_knobs_ride_the_steps_one_transfer_bit_exactly():
    rng = np.random.default_rng(10)
    logits = torch.from_numpy((rng.standard_normal((4, 64)) * 2)
                              .astype(np.float32))
    st = _sampled_state(state_for_slots, SamplingParams, 4)
    assert host_knobs(greedy_state(4)) == ()
    assert device_knobs(()) is None
    arrays = host_knobs(st)
    assert all(a.dtype == np.int32 for a in arrays)
    _, *dev = to_device("cpu", np.zeros((4, 3), np.int32), *arrays)
    knobs = device_knobs(dev)
    for got, want in zip(knobs, (st.temperature, st.top_k, st.top_p)):
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    # the u32 seed crosses as its bits; only the sampling rows are named
    np.testing.assert_array_equal(knobs.seed.numpy().view(np.uint32), st.seed)
    np.testing.assert_array_equal(knobs.step.numpy(), st.step)
    np.testing.assert_array_equal(knobs.rows.numpy(), [0, 1, 2])
    torch.testing.assert_close(filter_logits(logits, st, knobs),
                               filter_logits(logits, st), rtol=0, atol=0)
    np.testing.assert_array_equal(sample_tokens(logits, st, knobs).numpy(),
                                  sample_tokens(logits, st).numpy())


FILTERS = [dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.8),
           dict(temperature=0.9, top_k=12, top_p=0.6), dict(),
           dict(temperature=1.0), dict(temperature=0.5, top_k=1),
           dict(temperature=2.0, top_k=40, top_p=0.95)]


def test_reference_draws_fall_inside_the_ports_kept_set():
    """The port's draws ARE the reference's: the same tokens for 64 seeds
    (and the largest u32 seed) x 4 emission indices x a matrix of
    temperature / top-k / top-p rows (one greedy), at two vocab sizes."""
    rng = np.random.default_rng(8)
    b = len(FILTERS)
    draws = 0
    for V in (64, 1000):
        logits = (rng.standard_normal((b, V)) * 2).astype(np.float32)
        for seed in [*range(64), 0xFFFFFFFF]:
            for step in (0, 1, 7, 4096):
                st = jax_state(b, [(i, JaxSP(seed=seed, **f), step)
                                   for i, f in enumerate(FILTERS)])
                want = np.asarray(jax_sample(jnp.asarray(logits), st))
                got = sample_tokens(torch.from_numpy(logits), state_for_slots(
                    b, [(i, SamplingParams(seed=seed, **f), step)
                        for i, f in enumerate(FILTERS)])).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=str((V, seed, step)))
                draws += b
    assert draws == 2 * 65 * 4 * b


@pytest.mark.parametrize("seed_step", [(0, 0), (0xFFFFFFFF, 0), (1, 1)])
def test_threefry_fold_in_and_bits_are_bit_exact_with_jax(seed_step):
    """`fold_in(key(seed), step)`, the 32-bit draws and the uniforms of
    serve/prng.py against jax.random, for 256 (seed, step) pairs."""
    rng = np.random.default_rng(12)
    seeds = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    steps = rng.integers(0, 2 ** 31, 256).astype(np.int32)
    seeds[0], steps[0] = seed_step
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.key(s), c))(
        seeds, steps)
    k0, k1 = prng.fold_in(torch.from_numpy(seeds.astype(np.int64)),
                          torch.from_numpy(steps.astype(np.int64)))
    np.testing.assert_array_equal(
        np.stack([k0.numpy(), k1.numpy()], -1).astype(np.uint32),
        np.asarray(jax.random.key_data(keys)))
    n = 300
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(keys))
    np.testing.assert_array_equal(
        prng.random_bits(k0, k1, n).numpy().astype(np.uint32), want_bits)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=tiny, maxval=1.0))(keys))
    np.testing.assert_array_equal(prng.uniform(k0, k1, n).numpy().view(
        np.uint32), want_u.view(np.uint32))
    # Gumbel noise: the same uniforms through each library's log, which
    # may round differently in the last place
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys))
    np.testing.assert_allclose(prng.gumbel(k0, k1, n).numpy(), want_g,
                               rtol=2e-6, atol=2e-6)


def test_sampled_draw_is_pure_across_batch_composition_and_slot_order():
    rng = np.random.default_rng(9)
    row = (rng.standard_normal(64) * 2).astype(np.float32)
    sp = SamplingParams(temperature=1.0, top_p=0.95, seed=11)
    solo = sample_tokens(torch.from_numpy(row[None]),
                         state_for_slots(1, [(0, sp, 3)])).numpy()[0]
    for slot in range(4):
        batch = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
        batch[slot] = row
        others = [(i, SamplingParams(temperature=0.5, seed=i), i)
                  for i in range(4) if i != slot]
        st = state_for_slots(4, others + [(slot, sp, 3)])
        assert sample_tokens(torch.from_numpy(batch), st).numpy()[slot] == solo
    draws = {int(sample_tokens(torch.from_numpy(row[None]),
                               state_for_slots(1, [(0, sp, t)])).numpy()[0])
             for t in range(16)}
    assert len(draws) > 1                # the emission index drives the draw


def test_sampled_engine_streams_replay_identically(dense):
    cfg, _, pp = dense
    ps = _prompts(10, (12, 25), cfg.vocab_size)

    def run(order):
        server = LLMServer(port_cfg(cfg), pp, device="cpu", max_batch=2,
                           max_seq=64, page_size=8)
        streams = {i: server.generate(ps[i], SamplingParams(
            temperature=0.9, top_k=20, seed=100 + i, max_new_tokens=8),
            uid=i) for i in order}
        server.run()
        return {i: s.drain().tokens for i, s in streams.items()}

    assert run([0, 1]) == run([1, 0])


def test_sampled_engine_streams_match_the_reference(dense):
    """Sampled requests (with one greedy) through the engine, with a
    fork under its own seed: byte-identical to the reference engine."""
    cfg, jp, pp = dense
    ps = _prompts(13, (12, 25, 9), cfg.vocab_size)

    def run(server_cls, sp_cls, params, **kw):
        server = server_cls(cfg if server_cls is JaxServer else port_cfg(cfg),
                            params, max_batch=4, max_seq=64, page_size=8,
                            **kw)
        streams = [server.generate(p, sp_cls(
            max_new_tokens=9, seed=40 + i, **FILTERS[i]))
            for i, p in enumerate(ps)]
        next(streams[0])
        child = streams[0].fork(sp_cls(temperature=1.1, top_k=30, seed=99,
                                       max_new_tokens=9))
        server.run()
        return [s.drain().tokens for s in streams + [child]]

    want = run(JaxServer, JaxSP, jp)
    assert run(LLMServer, SamplingParams, pp, device="cpu") == want


# ------------------------------------------------------ entry points

def test_launch_serve_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "4",
         "--max-seq", "64", "--page-size", "8"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout


def test_launch_serve_caches_prefixes_and_spills_on_cpu():
    """The CLI's persistent prefix cache, host tier and watermark: with
    more requests than slots, later requests hit the shared system
    prompt their retired donors left in the cache, and at the end the
    pool holds exactly the cached (pinned) pages."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "6", "--max-batch", "2",
         "--max-new", "4", "--max-seq", "64", "--page-size", "8",
         "--prefix-cache", "--shared-prefix", "32",
         "--host-tier-pages", "64", "--high-watermark", "0.75"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "served 6 requests" in proc.stdout

    def stat(key):
        return int(re.search(rf"'{key}': (\d+)", proc.stdout).group(1))
    assert stat("cross_request_hits") > 0
    assert stat("allocated_pages") == stat("pinned_pages") == stat("entries")
    assert stat("capacity_pages") == 64


@pytest.mark.parametrize("draft", ["self:1", "mamba2-130m@reduced"])
def test_launch_serve_speculates_on_cpu(draft):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "6",
         "--max-seq", "64", "--page-size", "8", "--temperature", "0.8",
         "--speculate", "2", "--draft", draft],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout
    assert f"'spec': '{draft}'" in proc.stdout
    assert "'verify_calls': 0" not in proc.stdout


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "phi-3-vision-4.2b"])
def test_launch_serve_runs_the_moe_and_hybrid_archs_on_cpu(arch):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--max-new", "4",
         "--max-seq", "64", "--page-size", "8", "--temperature", "0.8"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(dense):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg, _, pp = dense
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(port_cfg(cfg), pp)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer(port_cfg(cfg))


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_engine_options_refuse(dense, kw):
    """No engine option of the reference is refused any more (`mesh` was
    the last): a mesh without a `mem` axis of more than one shard takes
    the single-arena path, as in the reference (the sharded arena is
    held in tests/test_torch_sharded_engine.py)."""
    from repro_torch.serve.kv_cache import PagedKVArena
    cfg, _, pp = dense
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", **kw)
    assert eng.mesh is None and type(eng.arena) is PagedKVArena


@pytest.mark.parametrize("family", ["encoder", "vlm"])
def test_the_encoder_is_refused_and_the_vlm_serves(family):
    """The encoder has no decode: the engine raises the reference's
    ValueError.  The vlm serves a request with its patch rows."""
    cfg = TINY[family]
    jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    pp = port_params(jp, cfg)
    if family == "encoder":
        with pytest.raises(ValueError) as want:
            JaxEngine(cfg, jp)
        with pytest.raises(ValueError) as got:
            ServingEngine(port_cfg(cfg), pp, device="cpu")
        assert str(got.value) == str(want.value) == \
            "family 'encoder' cannot serve (no decode)"
        return
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", max_batch=1,
                        max_seq=32, page_size=8)
    eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                       patch_embeds=image_rows(cfg, 0), max_new_tokens=3))
    res = eng.run()
    assert len(res[0].tokens) == 3
    assert eng.stats()["prefill_tokens"] == cfg.num_patches + 5
