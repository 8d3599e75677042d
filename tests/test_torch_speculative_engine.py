"""PyTorch port vs the JAX reference: the speculative engine, scripted.

The `_scenario` cases of `test_torch_serve.py` ("chunked", "preempt",
"fork_cancel_budget") with `speculate_k`/`draft` added, at TINY dense
and moe (grouped dispatch) in f32 on the CPU: the event streams,
`stats()` (pool, `peak_kv_bytes`, preemptions, the prefix store) and
`stats()["speculative"]` equal the reference engine's, and every stream
equals the port's own plain run of the same script (the reference's
contract: speculation changes how many tokens a tick yields, never
which).  A paired draft (`mamba2-130m@reduced`) gets the reference
draft's weights, converted, so both drafts propose the same windows."""
from __future__ import annotations

import pytest
import jax

from conftest import TINY
from repro.models import registry as jax_registry
from repro.serve import ServingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.serve.engine import Request, ServingEngine
from test_torch_serve import _drive, _scenario
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

CFGS = {"dense": TINY["dense"],
        "moe": TINY["moe"].replace(moe_dispatch="grouped")}

# (family, scenario, k, draft)
CASES = [("dense", "chunked", 1, "self:1"),
         ("dense", "chunked", 2, "self:1"),
         ("dense", "chunked", 4, "self:1"),
         ("dense", "preempt", 4, "self:1"),
         ("dense", "fork_cancel_budget", 2, "self:1"),
         ("dense", "chunked", 2, "mamba2-130m@reduced"),
         ("moe", "chunked", 2, "self:1")]


@pytest.fixture(scope="module")
def models():
    out = {}
    for family, cfg in CFGS.items():
        jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
        out[family] = (cfg, jp, port_params(jp, cfg))
    return out


def spec_scenario(name, vocab):
    """`_scenario` for a speculating engine.  "fork_cancel_budget" forks
    uid 10 two steps earlier: a speculating tick emits up to k+1 tokens,
    so by the plain script's step 7 the first fork has already
    finished."""
    kw, script = _scenario(name, vocab)
    if name == "fork_cancel_budget":
        script[5].append(("fork", 10, 11))
        script[7] = [("cancel", 3)]
    return kw, script


def finished(log) -> dict:
    return {uid: (reason, toks) for kind, uid, reason, toks in
            (e for e in log if e[0] == "finish")}


def assert_same_streams_as_plain(spec_log, plain_log):
    """Every request finishes as in the plain run; a cancelled one holds
    a prefix of the other run's tokens (the cancel lands at another
    point of its stream)."""
    spec, plain = finished(spec_log), finished(plain_log)
    assert sorted(spec) == sorted(plain)
    for uid, (reason, toks) in spec.items():
        p_reason, p_toks = plain[uid]
        if "cancelled" in (reason, p_reason):
            n = min(len(toks), len(p_toks))
            assert toks[:n] == p_toks[:n], uid
        else:
            assert (reason, toks) == (p_reason, p_toks), uid


@pytest.mark.parametrize("family, name, k, draft", CASES)
def test_speculative_engine_matches_reference_and_plain(models, family, name,
                                                        k, draft):
    cfg, jp, pp = models[family]
    kw, script = spec_scenario(name, cfg.vocab_size)
    ref = JaxEngine(cfg, jp, speculate_k=k, draft=draft, **kw)
    want = _drive(ref, JaxRequest, script)
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", speculate_k=k,
                        draft=draft, **kw)
    assert eng.draft.rewindable == ref.draft.rewindable
    assert (eng.fused_fn is None) == (ref.fused_fn is None)
    if not eng.draft.rewindable:
        eng.draft.params = port_params(ref.draft.params, ref.draft.cfg)
    got = _drive(eng, Request, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # incl. "speculative"
    sp = got[1]["speculative"]
    assert sp["k"] == k and sp["windows"] > 0 and sp["verify_calls"] > 0
    assert sp["draft"]["spec"] == draft
    assert got[1]["pool"]["allocated_pages"] == 0
    if name == "preempt":
        assert got[1]["preemptions"] > 0
    plain = _drive(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
                   Request, script)
    assert_same_streams_as_plain(got[0], plain[0])
