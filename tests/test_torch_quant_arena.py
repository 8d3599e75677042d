"""PyTorch port vs the JAX reference: the quantized page arena end to end.

With `kv_dtype` int8 or fp8 the arena stores K/V quantized on write with
per-token-per-head f32 scales beside them, and both paged kernels'
plain versions dequantize as they read.  At TINY in f32 (compute and
params) on the CPU: the dense engine in all four `_scenario` cases of
`test_torch_serve.py`, an int8 MoE (grouped dispatch) engine, and an
int8 hybrid server with sampled streams and a fork under its own seed,
give the reference's event streams and stats, and the arena the
reference's `page_bytes`.  (bf16 with a quantized arena has no
reference: ROADMAP.md §C.3.)"""
from __future__ import annotations

import pytest

from conftest import TINY
from repro.serve import ServingEngine as JaxEngine
from repro.serve.api import LLMServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.serve.api import LLMServer
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_serve import FILTERS, _drive, _prompts, _scenario
from torch_port_helpers import jax_family_params, port_cfg


@pytest.fixture(scope="module")
def params():
    """Reference and port params per family (the arena's dtype leaves
    the weights unchanged)."""
    return {"dense": jax_family_params(TINY["dense"]),
            "moe": jax_family_params(
                TINY["moe"].replace(moe_dispatch="grouped")),
            "hybrid": jax_family_params(TINY["hybrid"])}


def _engines(cfg, jp, pp, script, **kw):
    ref = JaxEngine(cfg, jp, **kw)
    want = _drive(ref, JaxRequest, script)
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", **kw)
    got = _drive(eng, Request, script)
    assert eng.arena.page_bytes == ref.arena.page_bytes
    assert sorted(eng.arena.kv) == sorted(ref.arena.kv)
    return want, got


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["chunked", "preempt", "fork_cancel_budget",
                                  "watermark"])
def test_quantized_dense_engine_matches_reference(params, kv_dtype, name):
    cfg = TINY["dense"].replace(kv_dtype=kv_dtype)
    jp, pp = params["dense"]
    kw, script = _scenario(name, cfg.vocab_size)
    want, got = _engines(cfg, jp, pp, script, **kw)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # incl. peak_kv_bytes
    assert got[1]["pool"]["allocated_pages"] == 0
    if name in ("preempt", "watermark"):
        assert got[1]["preemptions"] > 0


def test_int8_moe_engine_matches_reference(params):
    cfg = TINY["moe"].replace(moe_dispatch="grouped", kv_dtype="int8")
    jp, pp = params["moe"]
    kw, script = _scenario("chunked", cfg.vocab_size)
    want, got = _engines(cfg, jp, pp, script, **kw)
    assert got == want
    assert got[1]["prefix_store"]["reused_pages"] > 0


def test_int8_hybrid_sampled_streams_with_a_fork_match_reference(params):
    """Sampled streams over an int8 arena and per-slot conv/SSM state,
    with a fork under its own seed: the same tokens, pool statistics and
    page bytes as the reference server."""
    cfg = TINY["hybrid"].replace(kv_dtype="int8")
    jp, pp = params["hybrid"]
    ps = _prompts(13, (12, 25, 9), cfg.vocab_size)

    def run(server_cls, sp_cls, p, **kw):
        server = server_cls(cfg if server_cls is JaxServer else port_cfg(cfg),
                            p, max_batch=4, max_seq=64, page_size=8, **kw)
        streams = [server.generate(prompt, sp_cls(
            max_new_tokens=9, seed=40 + i, **FILTERS[i]))
            for i, prompt in enumerate(ps)]
        next(streams[0])
        child = streams[0].fork(sp_cls(temperature=1.1, top_k=30, seed=99,
                                       max_new_tokens=9))
        server.run()
        st = server.stats
        return ([s.drain().tokens for s in streams + [child]],
                st["peak_kv_bytes"], st["pool"],
                server.engine.arena.page_bytes)

    want = run(JaxServer, JaxSP, jp)
    got = run(LLMServer, SamplingParams, pp, device="cpu")
    assert got == want
    assert got[2]["allocated_pages"] == 0
