"""PyTorch port vs the JAX reference: speculative decode's parts.

At TINY in f32 on the CPU: `sampling.expand_state`/`verify_tokens`, the
registry's draft pairing, the page-table truncate laws, the
`DraftModel` (its windows AND every cache leaf after `sync`, `propose`
and `rollback`, for a rewindable self-draft and a recurrent-state
draft), and one `make_paged_verify_fn` step (target, accept and the
arena).  The engine cases are in `test_torch_speculative_engine.py`.
Tolerances as the f32 twins': atol = rtol = 1e-5 for floats, tokens and
positions exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY
from repro.core.unimem import SequencePageTable as JaxTable
from repro.core.unimem import UniMemPool as JaxPool
from repro.models import registry as jax_registry
from repro.serve.sampling import SamplingParams as JaxSP
from repro.serve.sampling import expand_state as jax_expand
from repro.serve.sampling import state_for_slots as jax_state
from repro.serve.sampling import verify_tokens as jax_verify
from repro.serve.serve_step import make_paged_verify_fn as jax_verify_fn
from repro.serve.speculative import DraftModel as JaxDraft
from repro_torch.core.unimem import SequencePageTable, UniMemPool
from repro_torch.models import registry
from repro_torch.serve import DraftModel
from repro_torch.serve.sampling import (SamplingParams, device_knobs,
                                        expand_state, host_knobs,
                                        state_for_slots, verify_tokens)
from repro_torch.serve.serve_step import make_paged_verify_fn, to_device
from torch_port_helpers import port_cfg, port_params

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def dense():
    cfg = TINY["dense"].replace(max_seq=128)
    params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    return cfg, params, port_params(params, cfg)


def _states(b, entries):
    """The same slots lowered by both packages: (reference, port)."""
    return (jax_state(b, [(i, JaxSP(**kw), e) for i, kw, e in entries]),
            state_for_slots(b, [(i, SamplingParams(**kw), e)
                                for i, kw, e in entries]))


MIXED = [(0, {}, 5), (1, dict(temperature=0.7, seed=9), 2),
         (2, dict(temperature=1.1, top_k=8, seed=3), 0),
         (3, dict(temperature=0.9, top_p=0.8, seed=4), 11)]


# ------------------------------------------------------------ sampling

def test_expand_state_matches_reference():
    js, ts = _states(4, MIXED)
    for r in (1, 3, 5):
        want, got = jax_expand(js, r), expand_state(ts, r)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("knobs", ["in_transfer", "copied"])
def test_verify_tokens_matches_reference(k, knobs):
    """Greedy and sampled rows: the same logits and draft give the same
    target and accept, with the window's knobs riding one transfer
    (`host_knobs(expand_state(...))`) or copied by `verify_tokens`."""
    b, V = 4, 48
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((b, k + 1, V)).astype(np.float32)
    js, ts = _states(b, MIXED)
    want_t, _ = jax_verify(jnp.asarray(logits),
                           jnp.zeros((b, k), jnp.int32), js)
    draft = np.asarray(want_t)[:, :k].copy()
    draft[0, k - 1] = (draft[0, k - 1] + 1) % V     # row 0 rejects last
    draft[2, 0] = (draft[2, 0] + 1) % V             # row 2 rejects first
    want_t, want_a = jax_verify(jnp.asarray(logits), jnp.asarray(draft), js)
    kn = None
    if knobs == "in_transfer":
        kn = device_knobs(to_device("cpu", *host_knobs(expand_state(ts,
                                                                    k + 1))))
    got_t, got_a = verify_tokens(torch.from_numpy(logits),
                                 torch.from_numpy(draft), ts, kn)
    assert got_t.dtype == got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert list(got_a.numpy()[[0, 1, 2, 3]]) == [k - 1, k, 0, k]


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_registry_verify_eligibility_matches_reference(family):
    cfg = TINY[family]
    assert registry.has_verify(port_cfg(cfg)) == \
        jax_registry.has_verify(cfg) == (family in ("dense", "moe"))
    assert registry.has_decode(port_cfg(cfg)) == jax_registry.has_decode(cfg)


def test_registry_draft_pairs_match_reference():
    assert registry.DRAFT_PAIRS == jax_registry.DRAFT_PAIRS
    assert registry.SELF_DRAFT_PREFIX == jax_registry.SELF_DRAFT_PREFIX
    for name in ("tiny-dense", "internlm2-1.8b", "yi-9b"):
        cfg = TINY["dense"].replace(name=name)
        assert registry.default_draft(port_cfg(cfg)) == \
            jax_registry.default_draft(cfg)
    assert registry.default_draft(
        port_cfg(TINY["dense"].replace(name="internlm2-1.8b"))) \
        == "mamba2-130m"


@pytest.mark.parametrize("spec", ["self:1", "mamba2-130m",
                                  "mamba2-130m@reduced"])
def test_draft_config_matches_reference(dense, spec):
    cfg = dense[0]
    got = registry.draft_config(port_cfg(cfg), spec)
    assert got == port_cfg(jax_registry.draft_config(cfg, spec))
    assert got.vocab_size == cfg.vocab_size
    assert got.max_seq >= cfg.max_seq
    assert registry.is_self_draft(port_cfg(cfg), got) == \
        (spec == "self:1")


@pytest.mark.parametrize("spec", ["self:0", "self:2", "mamba2-130m@bogus"])
def test_draft_config_refuses_as_the_reference(dense, spec):
    cfg = dense[0]
    with pytest.raises(ValueError):
        jax_registry.draft_config(cfg, spec)
    with pytest.raises(ValueError):
        registry.draft_config(port_cfg(cfg), spec)


def test_self_draft_params_share_the_targets_storage(dense):
    cfg, _, pp = dense
    dcfg = registry.draft_config(port_cfg(cfg), "self:1")
    dp = registry.self_draft_params(pp, dcfg)
    assert len(dp["layers"]) == 1 and len(pp["layers"]) == 2
    assert dp["embed"].data_ptr() == pp["embed"].data_ptr()
    assert dp["ln_f"].data_ptr() == pp["ln_f"].data_ptr()
    assert dp["layers"][0]["attn"]["wq"].data_ptr() == \
        pp["layers"][0]["attn"]["wq"].data_ptr()


# -------------------------------------------------------- truncate laws

def _truncate_walk(pool_cls, table_cls):
    pool = pool_cls(8, 4)
    seq = table_cls(pool)
    seq.append_tokens(13)
    log = [len(seq.truncate(6)), seq.num_tokens, len(seq.pages),
           pool.free_pages, seq.truncate(6)]
    try:
        seq.truncate(7)
    except ValueError:
        log.append("grow refused")
    seq.release()
    log.append(pool.free_pages)
    # the speculative order: copy the shared boundary page on write,
    # append a fresh tail, truncate back; the fork peer is untouched
    parent = table_cls(pool)
    parent.append_tokens(6)
    child = parent.fork()
    log.append(child.cow_last_page() is not None)
    child.append_tokens(5)
    child.truncate(7)
    log += [child.num_tokens, len(child.pages),
            parent.pages[1] != child.pages[1]]
    child.release()
    log.append(parent.num_tokens)
    parent.release()
    log.append(pool.free_pages)
    return log


def test_truncate_laws_match_reference():
    got = _truncate_walk(UniMemPool, SequencePageTable)
    assert got == _truncate_walk(JaxPool, JaxTable)
    assert got == [2, 6, 2, 6, [], "grow refused", 8, True, 7, 2, True, 6,
                   8]


# ----------------------------------------------------------- the draft

def _cache_equal(port, ref, what):
    assert sorted(port.cache) == sorted(ref.cache), what
    for name, a in port.cache.items():
        want = np.asarray(ref.cache[name])
        if name == "pos":
            np.testing.assert_array_equal(a.numpy(), want,
                                          err_msg=f"{what}: pos")
        else:
            np.testing.assert_allclose(a.numpy(), want, **F32,
                                       err_msg=f"{what}: {name}")


def _drafts(dense, spec, b, max_seq=64):
    cfg, jp, pp = dense
    ref = JaxDraft(cfg, jp, spec, max_batch=b, max_seq=max_seq)
    port = DraftModel(port_cfg(cfg), pp, spec, max_batch=b, max_seq=max_seq,
                      device="cpu")
    if not port.rewindable:       # the reference draws its own weights
        port.params = port_params(ref.params, ref.cfg)
    return ref, port


@pytest.mark.parametrize("spec", ["self:1", "mamba2-130m@reduced"])
def test_draft_cache_leaves_match_reference(dense, spec):
    """Ragged syncs (a row that sits out, a row that resets), propose,
    rollback with rows accepting 2, k+1 and 0, a second propose: the
    windows are equal and, after every call, every cache leaf (K/V or
    conv/SSM state, and pos) equals the reference's."""
    k, b = 3, 3
    ref, port = _drafts(dense, spec, b)
    assert port.rewindable == ref.rewindable == (spec == "self:1")
    rng = np.random.default_rng(7)
    ctx = [rng.integers(1, 127, n).astype(np.int32) for n in (5, 9, 3)]
    js, ts = _states(b, [(0, {}, 0), (1, dict(temperature=0.9, seed=2), 0),
                         (2, {}, 0)])
    entries = [(0, ctx[0][:-1], True), (1, ctx[1][:-1], True)]
    for d in (ref, port):
        d.sync(entries)
    _cache_equal(port, ref, "sync")
    later = [(1, ctx[2], False), (2, ctx[2][:-1], True)]
    for d in (ref, port):
        d.sync(later)
    _cache_equal(port, ref, "second sync")
    last = np.asarray([ctx[0][-1], ctx[2][-1], ctx[2][-1]], np.int32)
    want = ref.propose(last, js, k)
    got = port.propose(last, ts, k)
    np.testing.assert_array_equal(got, np.asarray(want))
    _cache_equal(port, ref, "propose")
    target = np.concatenate([got, rng.integers(1, 127, (b, 1))],
                            axis=1).astype(np.int32)
    n = np.asarray([3, k + 1, 0], np.int32)
    ref.rollback(target, n)
    port.rollback(target, n)
    _cache_equal(port, ref, "rollback")
    js2 = js._replace(step=js.step + n)
    ts2 = ts._replace(step=ts.step + n)
    nxt = np.asarray([target[i, max(n[i] - 1, 0)] for i in range(b)],
                     np.int32)
    np.testing.assert_array_equal(port.propose(nxt, ts2, k),
                                  np.asarray(ref.propose(nxt, js2, k)))
    _cache_equal(port, ref, "second propose")
    port.copy_row(0, 2)
    ref.copy_row(0, 2)
    _cache_equal(port, ref, "copy_row")
    port.clear_row(1)
    ref.clear_row(1)
    _cache_equal(port, ref, "clear_row")


@pytest.mark.parametrize("spec", ["self:1", "mamba2-130m@reduced"])
def test_draft_rollback_equals_a_fresh_draft(dense, spec):
    """After propose + rollback(n) the next window equals a fresh
    draft's fed the accepted context (the reference's law)."""
    k, b = 3, 2
    ctx = np.asarray([[3, 5, 7, 9], [11, 13, 17, 19]], np.int32)
    _, ts = _states(b, [(0, {}, 0), (1, dict(temperature=0.9, seed=2), 0)])
    cfg, _, pp = dense
    d1, d2 = (DraftModel(port_cfg(cfg), pp, spec, max_batch=b, max_seq=64,
                         device="cpu") for _ in range(2))
    d1.sync([(i, ctx[i, :-1], True) for i in range(b)])
    w1 = d1.propose(ctx[:, -1], ts, k)
    accepted = np.asarray([2, 0], np.int32)
    target = np.concatenate([w1, np.zeros((b, 1), np.int32)], axis=1)
    d1.rollback(target, accepted + 1)
    ts2 = ts._replace(step=ts.step + accepted + 1)
    nxt = np.asarray([target[0, 2], target[1, 0]], np.int32)
    full = [np.concatenate([ctx[i], w1[i, :accepted[i]], nxt[i:i + 1]])
            for i in range(b)]
    d2.sync([(i, full[i][:-1], True) for i in range(b)])
    np.testing.assert_array_equal(d1.propose(nxt, ts2, k),
                                  d2.propose(nxt, ts2, k))


# ---------------------------------------------------------- verify step

@pytest.mark.parametrize("family, dispatch", [("dense", None),
                                              ("moe", "scatter"),
                                              ("moe", "grouped")])
def test_paged_verify_step_matches_reference(family, dispatch):
    """One verify step at k = 2 (a chunk of 3) after a prefill: row 0's
    window crosses from its partial page into a fresh one, row 1 is
    inert, row 2 shares row 0's full first page and writes its own copy
    of the partial one, row 3 stays inside its first page; greedy and
    sampled rows.  target, accept and every non-null page are equal."""
    cfg = TINY[family]
    if dispatch:
        cfg = cfg.replace(moe_dispatch=dispatch)
    jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    pp = port_params(jp, cfg)
    jfam, pfam = jax_registry.get_family(cfg), registry.get_family(
        port_cfg(cfg))
    k, page, P, mp, b = 2, 8, 8, 4, 4
    rng = np.random.default_rng(3)
    ja = jfam.init_paged_cache(cfg, P + 1, page)
    ta = pfam.init_paged_cache(port_cfg(cfg), P + 1, page, device="cpu")
    # prefill: row 0 fourteen tokens in pages 0, 1; row 3 five in page 4
    bt = np.full((b, mp), P, np.int32)
    bt[0, :2] = [0, 1]
    bt[3, :1] = [4]
    tokens = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
    start = np.zeros((b,), np.int32)
    clen = np.asarray([14, 0, 0, 5], np.int32)
    ja, _ = jfam.paged_prefill(jp, cfg, {"tokens": jnp.asarray(tokens)}, ja,
                               jnp.asarray(bt), jnp.asarray(start),
                               jnp.asarray(clen))
    ta, _ = pfam.paged_prefill(pp, port_cfg(cfg),
                               {"tokens": torch.from_numpy(tokens)}, ta,
                               torch.from_numpy(bt), torch.from_numpy(start),
                               torch.from_numpy(clen))
    # row 2 forks row 0: page 0 shared, page 1 copied on write into 2
    ja = {n: a.at[:, 2].set(a[:, 1]) for n, a in ja.items()}
    for a in ta.values():
        a[:, 2].copy_(a[:, 1])
    bt[2, :2] = [0, 2]
    bt[0, 2], bt[2, 2] = 3, 5                      # room for the window
    start = np.asarray([14, 0, 14, 5], np.int32)
    clen = np.asarray([k + 1, 0, k + 1, k + 1], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (b, k + 1)).astype(np.int32)
    draft = chunk[:, 1:].copy()
    js, ts = _states(b, [(0, {}, 3), (2, dict(temperature=0.8, seed=5), 3),
                         (3, dict(temperature=1.2, top_k=20, seed=6), 0)])
    ja, want_t, want_a = jax_verify_fn(cfg)(
        jp, {"tokens": jnp.asarray(chunk)}, ja, jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(clen), jnp.asarray(draft), js)
    ta, got_t, got_a = make_paged_verify_fn(port_cfg(cfg), "cpu")(
        pp, {"tokens": chunk}, ta, bt, start, clen, draft, ts)
    live = clen > 0
    np.testing.assert_array_equal(got_t.numpy()[live],
                                  np.asarray(want_t)[live])
    np.testing.assert_array_equal(got_a.numpy()[live],
                                  np.asarray(want_a)[live])
    for name in ("k", "v"):                        # the null page is garbage
        np.testing.assert_allclose(ta[name][:, :P].numpy(),
                                   np.asarray(ja[name])[:, :P], **F32)
    # each window's last candidate landed in its fresh page (row 0: page
    # 3, row 2: page 5), and row 2 wrote its own copy of the partial page
    assert bool((ta["k"][:, 3, 0] != 0).any()) and \
        bool((ta["k"][:, 5, 0] != 0).any())
    assert not bool((ta["k"][:, 3, 1:] != 0).any())
    assert torch.equal(ta["k"][:, 1, :6], ta["k"][:, 2, :6])
    assert not torch.equal(ta["k"][:, 1, 6:], ta["k"][:, 2, 6:])


def test_verify_fn_refuses_families_without_a_verify_hook():
    for family in ("ssm", "hybrid"):
        with pytest.raises(ValueError):
            make_paged_verify_fn(port_cfg(TINY[family]), "cpu")
