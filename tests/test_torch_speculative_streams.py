"""PyTorch port vs the JAX reference: speculative streams of sampled
requests, the opt-out, stop tokens, fork hygiene and the refusals.

TINY dense (max_seq 128) in f32 on the CPU, with the reference's
`tests/test_speculative.py` request mix (odd uids sample, one with
top-k): the port's speculative streams equal the reference's
speculative streams and the port's own plain decode, and the
speculative stats equal the reference's."""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import jax

from conftest import TINY
from repro.models import registry as jax_registry
from repro.serve import ServingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dense():
    cfg = TINY["dense"].replace(max_seq=128)
    jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    return cfg, jp, port_params(jp, cfg)


def _requests(request_cls, sp_cls, vocab, n=4, max_new=12, seed=0,
              stops=None, **sp_kw):
    """A mixed greedy/sampled request set (odd uids sample)."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n):
        prompt = rng.integers(1, vocab - 1,
                              size=int(rng.integers(4, 20))).astype(np.int32)
        sp = sp_cls(temperature=0.0 if u % 2 == 0 else 0.8,
                    top_k=16 if u == 3 else 0, seed=u,
                    max_new_tokens=max_new, **sp_kw)
        if stops is not None:
            sp = replace(sp, stop=(stops[u],))
        out.append(request_cls(uid=u, prompt=prompt, sampling=sp))
    return out


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.uid: (tuple(r.tokens), r.finish_reason) for r in engine.run()}


def _both(dense, req_kw=None, **kw):
    """(reference streams, reference engine, port streams, port engine,
    the port's plain streams) of one request set."""
    cfg, jp, pp = dense
    req_kw = req_kw or {}
    ekw = dict(max_batch=4, max_seq=cfg.max_seq, page_size=8)
    ref = JaxEngine(cfg, jp, **ekw, **kw)
    want = _run(ref, _requests(JaxRequest, JaxSP, cfg.vocab_size, **req_kw))
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", **ekw, **kw)
    if not eng.draft.rewindable:
        eng.draft.params = port_params(ref.draft.params, ref.draft.cfg)
    got = _run(eng, _requests(Request, SamplingParams, cfg.vocab_size,
                              **req_kw))
    plain = _run(ServingEngine(port_cfg(cfg), pp, device="cpu", **ekw),
                 _requests(Request, SamplingParams, cfg.vocab_size, **req_kw))
    return want, ref, got, eng, plain


@pytest.mark.parametrize("k, draft", [(1, "self:1"), (4, "self:1"),
                                      (2, "mamba2-130m@reduced")])
def test_sampled_speculative_streams_match_reference_and_plain(dense, k,
                                                               draft):
    want, ref, got, eng, plain = _both(dense, speculate_k=k, draft=draft)
    assert got == want == plain
    assert eng.stats()["speculative"] == ref.stats()["speculative"]
    assert eng.stats()["speculative"]["windows"] > 0
    assert eng.pool.stats().allocated_pages == 0


def test_opt_out_pins_plain_decode(dense):
    want, ref, got, eng, plain = _both(
        dense, req_kw=dict(speculative=False), speculate_k=4, draft="self:1")
    assert got == want == plain
    assert eng.stats()["speculative"] == ref.stats()["speculative"]
    assert eng.stats()["speculative"]["windows"] == 0


def test_stop_tokens_inside_an_accepted_window(dense):
    """A stop token inside an accepted window ends the stream at the
    stop, as plain decode does (no tail emissions from the window)."""
    cfg, _, pp = dense
    base = _run(ServingEngine(port_cfg(cfg), pp, device="cpu", max_batch=4,
                              max_seq=cfg.max_seq, page_size=8),
                _requests(Request, SamplingParams, cfg.vocab_size, n=2,
                          max_new=24, seed=5))
    stops = {u: int(t[len(t) // 2]) for u, (t, _) in base.items()}
    want, ref, got, eng, plain = _both(
        dense, req_kw=dict(n=2, max_new=24, seed=5, stops=stops),
        speculate_k=4, draft="self:1")
    assert got == want == plain
    assert eng.stats()["speculative"] == ref.stats()["speculative"]
    for toks, reason in got.values():
        assert reason == "stop" and len(toks) < 24


def _balanced(eng) -> None:
    """Every pool refcount is the number of live tables holding the page
    plus the store's own reference; every store entry's refs is the
    number of live slots holding it."""
    store = eng.prefix_store
    want: dict[int, int] = {}
    for s in eng.slots.values():
        for p in s.pages.pages:
            want[p] = want.get(p, 0) + 1
    for h, e in store._entries.items():
        want[e.page] = want.get(e.page, 0) + 1
        assert e.refs == sum(h in s.store_refs for s in eng.slots.values())
    assert eng.pool._refcount == want


def test_reject_heavy_fork_children_retire_clean(dense):
    """Fork children decode speculatively over copied-on-write pages
    under sampled regimes that disagree with the draft often, then
    retire: nothing is registered after the forks, every refcount
    balances at every step, and the pool ends empty.  (The reference's
    twin needs `prefix_cache=True`; this runs the default store.)  The
    streams equal the reference engine's."""
    cfg, jp, pp = dense
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab_size - 1, 24).astype(np.int32)
    out = []
    for engine_cls, req_cls, sp_cls, params, kw in (
            (JaxEngine, JaxRequest, JaxSP, jp, {}),
            (ServingEngine, Request, SamplingParams, pp, dict(device="cpu"))):
        c = cfg if engine_cls is JaxEngine else port_cfg(cfg)
        eng = engine_cls(c, params, max_batch=4, max_seq=cfg.max_seq,
                         page_size=8, speculate_k=4, draft="self:1", **kw)
        eng.submit(req_cls(uid=0, prompt=prompt,
                           sampling=sp_cls(max_new_tokens=30)))
        while not any(s.generated for s in eng.slots.values()):
            eng.step()
        registered = eng.prefix_store.registered_pages
        for new_uid, seed in ((1, 11), (2, 12)):
            eng.fork(0, new_uid, sampling=sp_cls(
                temperature=1.3, seed=seed, max_new_tokens=30))
        while eng.pending or eng.slots:
            eng.step()
            if engine_cls is ServingEngine:
                _balanced(eng)
        assert eng.prefix_store.registered_pages == registered
        st = eng.stats()
        assert st["prefix_store"]["entries"] == 0
        assert st["pool"]["allocated_pages"] == 0
        assert st["pool"]["pinned_pages"] == 0
        out.append(({r.uid: tuple(r.tokens) for r in eng.results},
                    st["speculative"]))
    assert out[1] == out[0]
    assert out[1][1]["accept_rate"] < 1.0


@pytest.mark.parametrize("family, kw", [("hybrid", {}),
                                        ("dense", dict(layout="contiguous"))])
def test_speculation_refuses_as_the_reference(dense, family, kw):
    """Hybrid has no verify hook and the contiguous layout no pages:
    both engines raise ValueError."""
    cfg = TINY[family]
    jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    with pytest.raises(ValueError):
        JaxEngine(cfg, jp, max_seq=64, speculate_k=2, **kw)
    with pytest.raises(ValueError):
        ServingEngine(port_cfg(cfg), port_params(jp, cfg), device="cpu",
                      max_seq=64, speculate_k=2, **kw)
