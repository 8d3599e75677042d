"""The port's persistent prefix cache and host-DRAM tier in the engine,
held against the reference engine on the same params.

Each scenario runs the reference engine once (module-scoped: its
compiles are most of this file's time) and the port's engine on the
converted params; the reference's run is the oracle for the event
streams, for `stats()`'s `prefix_store`, `host_tier`, `pool` and
`preemptions`, key for key, and for the store's entries and the tier's
parcels.  The scenarios mirror the reference's own
(`tests/test_prefix_store.py`, `tests/test_kv_quant_tier.py`): hits
after the donor retired (dense bf16 and int8, vlm, hybrid), a hit from
a cold parcel, the watermark shedding idle cache before it preempts,
spill and restore (bf16 and int8 pages), a tier too small, hybrid never
spilling, fork children holding store refs, and the cancel of a spilled
request.  The arena's page traffic (`read_pages`, `write_pages`,
`prefetch`) is held to the reference arena's `read_pages` and
`write_page`.  The reference serves under its default
`attention_impl="flash_xla"`."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import TINY
from repro.models import registry as jax_registry
from repro.serve import engine as jax_engine
from repro.serve import serve_step as jax_serve_step
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.kv_cache import PagedKVArena as JaxArena
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.kv_cache import PagedKVArena
from test_torch_serve import _events
from torch_port_helpers import port_cfg, port_params, tensor_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

STAT_KEYS = ("steps", "tokens_out", "prefill_tokens", "admitted",
             "preemptions", "cancellations", "peak_kv_bytes",
             "prefill_shapes", "pool", "prefix_store", "host_tier")

_PARAMS: dict = {}


def _params(fam):
    """(reference params, the port's) of TINY[fam], made once by the
    reference's init, compiled (a third of its eager time here)."""
    if fam not in _PARAMS:
        cfg = TINY[fam]
        init = jax_registry.get_family(cfg).init
        jp = jax.jit(lambda key: init(key, cfg))(jax.random.key(0))
        _PARAMS[fam] = (jp, port_params(jp, cfg))
    return _PARAMS[fam]


# ------------------------------------------------------------- requests

def _wave_requests(cfg, seed, n, system_len=24, tail_len=6, max_new=6):
    """`n` requests behind one seeded system prompt (and, for vlm, one
    image): (uid, prompt, max_new_tokens, patch_embeds)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size - 1, system_len)
    patches = (rng.standard_normal((cfg.num_patches, cfg.frontend_dim))
               .astype(np.float32) if cfg.frontend == "patch" else None)
    return [(uid, np.concatenate([system, rng.integers(
        1, cfg.vocab_size - 1, tail_len)]).astype(np.int32), max_new, patches)
        for uid in range(n)]


def _mixed_requests(cfg, n, max_new, seed=0):
    """The reference tier tests' mix: prompts of 8-27 tokens."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(1, cfg.vocab_size - 1,
                               int(rng.integers(8, 28))).astype(np.int32),
             max_new, None) for uid in range(n)]


def _submit_all(reqs):
    return {0: [("submit", *r) for r in reqs]}


def _scenario(name):
    """(family, kv_dtype, engine kwargs, stages): a stage is a script
    (step -> actions, run until the engine is idle) or "flush" (evict
    every idle store entry, spilling it cold).  Every scenario has one
    geometry (4 slots, 16 pages of 8 tokens, chunks of 8) and bf16
    pages but the int8 ones, so the reference compiles once per family
    and page dtype."""
    kw = dict(max_batch=4, max_seq=64, page_size=8, pool_pages=16,
              prefill_chunk=8)
    if name in ("dense_cache", "int8_cache", "vlm_cache"):
        fam = "vlm" if name == "vlm_cache" else "dense"
        kv = "int8" if name == "int8_cache" else "bf16"
        reqs = _wave_requests(TINY[fam], 21, 4)
        kw.update(prefix_cache=True)
        stages = [_submit_all(reqs[:1]), _submit_all(reqs[1:])]
        if name == "dense_cache":
            # a hit after the donor retired, then the cache flushed out of
            # the device pool into host DRAM and pulled back by the rest
            kw.update(host_tier_pages=16)
            stages = [_submit_all(reqs[:1]), _submit_all(reqs[1:2]),
                      "flush", _submit_all(reqs[2:])]
        return fam, kv, kw, stages
    if name == "hybrid":
        # shared prompts under pool pressure: pages adopted but every
        # token recomputed, and preempted slots never spill
        reqs = _wave_requests(TINY["hybrid"], 21, 5)
        kw.update(prefix_cache=True, high_watermark=0.6, host_tier_pages=64)
        return "hybrid", "bf16", kw, [_submit_all(reqs[:1]),
                                    _submit_all(reqs[1:])]
    if name == "watermark":
        rng = np.random.default_rng(33)
        reqs = [(uid, rng.integers(1, 127, 24).astype(np.int32), 4, None)
                for uid in range(6)]
        kw.update(prefix_cache=True, high_watermark=0.8)
        return "dense", "bf16", kw, [_submit_all(reqs[:3]),
                                     _submit_all(reqs[3:])]
    if name in ("spill_bf16", "spill_int8", "tier_small", "cancel_spilled"):
        kv = "int8" if name == "spill_int8" else "bf16"
        reqs = _mixed_requests(TINY["dense"], 6, 12)
        kw.update(high_watermark=0.75,
                  host_tier_pages=4 if name == "tier_small" else 64)
        script = _submit_all(reqs)
        if name == "cancel_spilled":
            script[1] = [("cancel_spilled",)]
        return "dense", kv, kw, [script]
    if name == "fork":
        prompt = ((np.arange(24) * 5) % 128).astype(np.int32)
        kw.update(prefix_cache=True)
        return "dense", "bf16", kw, [
            {0: [("submit", 0, prompt, 8, None)], 1: [("fork_decoding",)]},
            {0: [("submit", 2, prompt.copy(), 4, None)]}]
    raise ValueError(name)


SCENARIOS = ("dense_cache", "int8_cache", "vlm_cache", "hybrid",
             "watermark", "spill_bf16", "spill_int8", "tier_small", "fork",
             "cancel_spilled")


# -------------------------------------------------------------- driving

def _store_state(eng):
    store, tier = eng.prefix_store, eng.host_tier
    out = {"entries": [(h, e.page, e.parent, e.index, e.refs, e.children)
                       for h, e in store._entries.items()]}
    if tier is not None:
        out["parcels"] = [(k, p.num_pages, p.meta)
                          for k, p in tier._parcels.items()]
    return out


def _act(engine, request_cls, act, log, pending_acts):
    kind = act[0]
    if kind == "submit":
        _, uid, prompt, n, patches = act
        engine.submit(request_cls(uid=uid, prompt=prompt.copy(),
                                  max_new_tokens=n, patch_embeds=patches))
        return
    # the conditional actions retry every step until they fire
    if kind == "fork_decoding":
        src = next((s for s in engine.slots.values()
                    if s.request.uid == 0 and s.generated
                    and not s.prefilling), None)
        if src is None:
            pending_acts.append(act)
            return
        engine.fork(0, new_uid=1)
        log.append(("forked", sorted(
            (h, engine.prefix_store.entry(h).refs) for h in src.store_refs)))
        return
    if kind == "cancel_spilled":
        uid = next((r.uid for r in engine.pending
                    if r.uid in engine.host_tier), None)
        if uid is None:
            pending_acts.append(act)
            return
        log.append(("cancel", uid, engine.cancel(uid),
                    uid in engine.host_tier, uid in engine._prefetched))
        return
    raise ValueError(kind)


def _drive(engine, request_cls, stages):
    log, last_parcels = [], []
    for stage in stages:
        if stage == "flush":
            store = engine.prefix_store
            log.append(("flush", store.evict(len(store)), _store_state(engine)))
            continue
        step, retry = 0, []
        while True:
            acts, retry = retry + list(stage.get(step, ())), []
            for act in acts:
                _act(engine, request_cls, act, log, retry)
            if not (engine.pending or engine.slots or retry) \
                    and step > max(stage):
                break
            engine.step()
            log.extend(_events(engine.events()))
            if engine.host_tier is not None:     # every spill and restore
                parcels = _store_state(engine)["parcels"]
                if parcels != last_parcels:
                    log.append(("parcels", parcels))
                    last_parcels = parcels
            step += 1
            assert step < 500
    st = engine.stats()
    stats = {k: st[k] for k in STAT_KEYS if k in st}
    return log, stats, _store_state(engine)


_REF_FNS: dict = {}


def _shared_ref_fns(cfg):
    """The reference's jitted step closures depend on the config only:
    scenarios of one config share them, and with them their compiles."""
    if cfg not in _REF_FNS:
        _REF_FNS[cfg] = jax_serve_step.make_paged_serve_fns(cfg)
    return _REF_FNS[cfg]


def _engines(name):
    fam, kv, kw, stages = _scenario(name)
    cfg = TINY[fam].replace(kv_dtype=kv)
    jp, pp = _params(fam)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "make_paged_serve_fns", _shared_ref_fns)
        ref = JaxEngine(cfg, jp, **kw)
    want = _drive(ref, JaxRequest, stages)
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", **kw)
    _count_prefetch_restores(eng)
    got = _drive(eng, Request, stages)
    return want, got, eng


def _count_prefetch_restores(eng):
    """Count on `eng.restored_from_prefetch` the restores that wrote a
    prefetched copy back (not the parcel's own host tensors)."""
    arena = eng.arena
    staged, prefetch, write_pages = [], arena.prefetch, arena.write_pages
    eng.restored_from_prefetch = 0

    def counted_prefetch(data):
        out = prefetch(data)
        staged.append(out[0])
        return out

    def counted_write_pages(pages, data, ready=None):
        eng.restored_from_prefetch += any(data is d for d in staged)
        return write_pages(pages, data, ready=ready)
    arena.prefetch, arena.write_pages = counted_prefetch, counted_write_pages


@pytest.fixture(scope="module", params=SCENARIOS)
def scenario(request):
    return request.param, *_engines(request.param)


# ---------------------------------------------------------------- tests

def test_event_streams_match_the_reference(scenario):
    _, want, got, _ = scenario
    assert got[0] == want[0]                       # byte-identical streams


def test_stats_store_and_tier_match_the_reference(scenario):
    _, want, got, _ = scenario
    assert got[1] == want[1]                       # key for key
    assert got[2] == want[2]                       # entries, parcels


def _prompt_tokens(name):
    fam, _, _, stages = _scenario(name)
    return sum(len(a[2]) + (0 if a[4] is None else len(a[4]))
               for st in stages if st != "flush"
               for acts in st.values() for a in acts if a[0] == "submit")


def test_scenario_shows_its_behaviour(scenario):
    """What each scenario is for, read from the port's own run."""
    name, _, (log, st, _), eng = scenario
    store, tier, pool = st["prefix_store"], st.get("host_tier"), st["pool"]
    if name in ("dense_cache", "int8_cache", "vlm_cache", "fork"):
        assert store["cross_request_hits"] > 0
        assert st["prefill_tokens"] < _prompt_tokens(name)
    if name == "hybrid":
        # adopts the cached pages, but recomputes every prompt token, and
        # its preempted slots never spill
        assert store["cross_request_hits"] > 0
        assert st["prefill_tokens"] >= _prompt_tokens(name)
        assert st["preemptions"] > 0 and tier["spills"] == 0
    if name == "dense_cache":
        flushed = [e[1] for e in log if e[0] == "flush"]
        assert flushed[0] > 0 and store["cold_spills"] == sum(flushed)
        assert store["cold_restores"] > 0 and tier["restores"] > 0
    if name == "watermark":
        assert store["evictions"] > 0 and st["preemptions"] == 0
    if store["persistent"]:
        assert pool["allocated_pages"] == pool["pinned_pages"] \
            == store["entries"] > 0
    else:
        assert pool["allocated_pages"] == 0 and store["entries"] == 0
    if name in ("spill_bf16", "spill_int8"):
        assert st["preemptions"] > 0
        assert tier["spills"] > 0 and tier["restores"] > 0
        assert tier["prefetches"] > 0 and eng.restored_from_prefetch > 0
        assert tier["restored_pages"] == tier["spilled_pages"]
        assert tier["resident_pages"] == 0         # every parcel restored
    if name == "tier_small":
        assert tier["spills"] > 0
        assert tier["restored_pages"] < tier["spilled_pages"]
    if name == "fork":
        forked = next(e[1] for e in log if e[0] == "forked")
        assert forked and all(refs == 2 for _, refs in forked)
    if name == "cancel_spilled":
        _, uid, ok, parcel_left, prefetch_left = next(
            e for e in log if e[0] == "cancel")
        assert ok and not parcel_left and not prefetch_left
        assert ("finish", uid, "cancelled") in [e[:3] for e in log]
        assert st["cancellations"] == 1 and tier["resident_pages"] == 0


@pytest.mark.parametrize("name", ["spill_bf16", "spill_int8", "tier_small",
                                  "watermark", "hybrid", "int8_cache",
                                  "vlm_cache"])
def test_streams_equal_the_all_hbm_streams(name):
    """The port alone: spilling (and falling back to recompute when the
    tier is too small) and caching never change a token against a pool
    that never preempts and shares pages only between requests in
    flight."""
    fam, kv, kw, stages = _scenario(name)
    cfg = port_cfg(TINY[fam].replace(kv_dtype=kv))
    _, pp = _params(fam)

    def tokens(**over):
        eng = ServingEngine(cfg, pp, device="cpu", **{**kw, **over})
        log, st, _ = _drive(eng, Request, stages)
        return {e[1]: e[3] for e in log if e[0] == "finish"}, st
    spilled, st = tokens()
    assert st["preemptions"] > 0 or st["prefix_store"]["persistent"]
    hbm, st = tokens(pool_pages=64, high_watermark=None,
                     host_tier_pages=None, prefix_cache=False)
    assert st["preemptions"] == 0 and spilled == hbm


# -------------------------------------------------------- arena traffic

def _bits(a):
    """A reference arena leaf as comparable numpy (bf16 as its bits)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _twin_arenas(kv):
    """A reference and a port arena of TINY["dense"] with the same seeded
    contents in every leaf."""
    cfg = TINY["dense"].replace(kv_dtype=kv)
    ref = JaxArena(cfg, num_pages=12, page_size=8)
    port = PagedKVArena(port_cfg(cfg), num_pages=12, page_size=8,
                        device=torch.device("cpu"))
    rng = np.random.default_rng(7)
    for name, a in ref.kv.items():
        x = rng.standard_normal(a.shape).astype(np.float32)
        if a.dtype == jnp.int8:
            x = np.clip(np.round(x * 40), -127, 127)
        ref.kv[name] = jnp.asarray(x).astype(a.dtype)
        port.kv[name].copy_(torch.from_numpy(x).to(port.kv[name].dtype))
    for name, a in ref.kv.items():
        assert np.array_equal(tensor_to_numpy(port.kv[name]), _bits(a))
    return ref, port


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_read_pages_returns_the_reference_payload(kv):
    ref, port = _twin_arenas(kv)
    pages = [5, 2, 9]
    want = ref.read_pages(pages)
    got = port.read_pages(pages)
    assert sorted(got) == sorted(want)             # scales travel too
    for name, a in want.items():
        assert got[name].device.type == "cpu"
        assert np.array_equal(tensor_to_numpy(got[name]), _bits(a))
    one = port.read_page(2)
    assert all(np.array_equal(tensor_to_numpy(one[n]), _bits(want[n][:, 1]))
               for n in want)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("prefetched", [False, True])
def test_write_pages_restores_as_the_reference_write_page(kv, prefetched):
    """A batched restore (from the host payload, or through the
    prefetch's copy) leaves the arena as the reference's page-by-page
    `write_page` of the same payload."""
    ref, port = _twin_arenas(kv)
    src, dst = [1, 4, 6], [10, 3, 0]
    payload = port.read_pages(src)
    ref_payload = ref.read_pages(src)
    for j, pg in enumerate(dst):
        ref.write_page(pg, {n: a[:, j] for n, a in ref_payload.items()})
    if prefetched:
        staged, ready = port.prefetch(payload)
        assert ready is None                       # the CPU: a plain copy
        assert all(staged[n].data_ptr() != payload[n].data_ptr()
                   for n in payload)
        port.write_pages(dst, staged, ready=ready)
    else:
        port.write_pages(dst, payload)
    for name, a in ref.kv.items():
        assert np.array_equal(tensor_to_numpy(port.kv[name]), _bits(a))
    for name in payload:                           # the round trip holds
        assert torch.equal(port.kv[name][:, dst], port.kv[name][:, src])
