"""PyTorch port vs the JAX reference: the quantized page arena end to end.

With `kv_dtype` int8 or fp8 the arena stores K/V quantized on write with
per-token-per-head f32 scales beside them, and both paged kernels'
plain versions dequantize as they read.  At TINY in f32 (compute and
params) on the CPU: the dense engine in all four `_scenario` cases of
`test_torch_serve.py`, an int8 MoE (grouped dispatch) engine, and an
int8 hybrid server with sampled streams and a fork under its own seed,
give the reference's event streams and stats, and the arena the
reference's `page_bytes`.  In bf16 (compute and params), where the
reference's own engine cannot run a quantized arena, the dense paged
steps are held to the port's bf16 steps over the dequantized pages (the
quantization contract), and the bf16 engine to the reference's f32
quantized engine at the same (bf16-valued) weights."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.serve import ServingEngine as JaxEngine
from repro.serve.api import LLMServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.serve.api import LLMServer
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.core.unimem import quantize_kv
from repro_torch.models import transformer as PT
from test_torch_moe import _paged_case
from test_torch_serve import FILTERS, _drive, _prompts, _scenario
from torch_port_helpers import jax_family_params, port_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)


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


# ------------------------------------------------------------------ bf16

def _bf16_params(p):
    """The port's params with every float leaf rounded to bf16."""
    if isinstance(p, dict):
        return {k: _bf16_params(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_bf16_params(v) for v in p]
    if torch.is_tensor(p) and p.is_floating_point():
        return p.to(torch.bfloat16)
    return p


def _bf16_cfg(cfg):
    return port_cfg(cfg.replace(dtype="bfloat16", param_dtype="bfloat16"))


def _dequantized(arena, name):
    """One K or V bank of a quantized arena as f32 values."""
    return arena[name].float() * arena[f"{name}_scale"][..., None]


def _quant_step(arena, name):
    """One quantization step of each (layer, page, token, head) row at
    its largest code: the scale (int8), or the scale times the spacing
    of e4m3 codes in [256, 448] (fp8)."""
    per_code = 1.0 if arena[name].dtype == torch.int8 else 32.0
    return arena[f"{name}_scale"][..., None] * per_code


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_bf16_quantized_paged_steps_follow_the_dequantized_pages(params,
                                                                 kv_dtype):
    """The quantization contract in bf16, at TINY dense: each step of the
    port's bf16 paged hooks over an int8 / fp8 arena (two ragged prefill
    chunks, then a decode step with an inactive row: the geometry of
    `run_paged_steps`) against the same step of the bf16 model over a
    bf16 arena that holds the quantized pages dequantized, with each new
    K/V quantized and dequantized as it is written.  Live rows' logits
    agree within 2**-7 of the largest (two bf16 roundings of it: the
    twin's pages are the dequantized values rounded to bf16); layer 0's
    new pages, computed by both from the same embeddings, are the same
    bits; every page of every layer agrees within two quantization steps
    of its row plus the bf16 rounding (2**-8): past layer 0 the two
    quantize K/V that differ by bf16 roundings, with scales that differ
    as their rows' largest values do."""
    cfg = _bf16_cfg(TINY["dense"].replace(kv_dtype=kv_dtype))
    twin_cfg = cfg.replace(kv_dtype=None)
    pp = _bf16_params(params["dense"][1])
    rng, page, P, b, bt = _paged_case(cfg, 0)
    bt = torch.from_numpy(bt)
    arena = PT.init_paged_cache(cfg, P + 1, page, device="cpu")
    store, write = cfg.kv_store_dtype, PT._paged_write_kv

    def twin_write(c, leaves, k, v, *rest):
        fq = [(q.float() * s[..., None]).to(t.dtype)
              for q, s, t in (quantize_kv(k, store) + (k,),
                              quantize_kv(v, store) + (v,))]
        return write(c, leaves, *fq, *rest)

    steps = [((0, 0, 0, 0), (8, 5, 8, 0)), ((8, 5, 8, 0), (8, 3, 0, 0)),
             ((16, 8, 8, 0), None)]
    for start, clen in steps:
        start = torch.tensor(start, dtype=torch.int32)
        twin = {n: _dequantized(arena, n).to(torch.bfloat16)
                for n in ("k", "v")}
        if clen is None:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b,)).astype(np.int32))
            args, fn, live = (bt, start, tokens), PT.paged_decode_step, \
                start > 0
        else:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, 8)).astype(np.int32))
            clen = torch.tensor(clen, dtype=torch.int32)
            args = ({"tokens": tokens}, bt, start, clen)
            fn, live = PT.paged_prefill, clen > 0
        if clen is None:
            arena, got = fn(pp, cfg, arena, *args)
        else:
            arena, got = fn(pp, cfg, args[0], arena, *args[1:])
        PT._paged_write_kv = twin_write
        try:
            if clen is None:
                twin, want = fn(pp, twin_cfg, twin, *args)
            else:
                twin, want = fn(pp, twin_cfg, args[0], twin, *args[1:])
        finally:
            PT._paged_write_kv = write
        got, want = got.float()[live], want.float()[live]
        assert (got - want).abs().max() <= 2 ** -7 * want.abs().max()
        for name in ("k", "v"):
            deq = _dequantized(arena, name)[:, :P]
            tw = twin[name][:, :P].float()
            assert torch.equal(deq[0].bfloat16().float(), tw[0]), name
            bound = 2 * _quant_step(arena, name)[:, :P] + 2 ** -8 * tw.abs()
            assert ((deq - tw).abs() <= bound).all(), name


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_bf16_quantized_engine_tracks_the_f32_reference_engine(params,
                                                               kv_dtype):
    """The port's bf16 engine over an int8 / fp8 arena against the
    reference's f32 engine over the same arena dtype, both at the
    reference's weights rounded to bf16 ("chunked": shared prefixes,
    chunked prefill): the same event streams and stats, the same
    `page_bytes`, and an arena within a stated bf16 bound: int8 codes
    within 2, fp8 values within two quantization steps of their row,
    every scale within 2**-6 of the reference's (the K/V computed in bf16
    against f32)."""
    cfg = TINY["dense"].replace(kv_dtype=kv_dtype)
    jp, pp = params["dense"]
    jpb = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), jp)
    kw, script = _scenario("chunked", cfg.vocab_size)
    ref = JaxEngine(cfg, jpb, **kw)
    want = _drive(ref, JaxRequest, script)
    eng = ServingEngine(_bf16_cfg(cfg), _bf16_params(pp), device="cpu", **kw)
    got = _drive(eng, Request, script)
    assert got == want
    assert got[1]["prefix_store"]["reused_pages"] > 0
    assert eng.arena.page_bytes == ref.arena.page_bytes
    P = eng.arena.num_pages
    ja = {n: torch.tensor(np.asarray(a.astype(jnp.float32))[:, :P])
          for n, a in ref.arena.kv.items()}
    ta = {n: a[:, :P].float() for n, a in eng.arena.kv.items()}
    for name in ("k", "v"):
        ts, js = ta[f"{name}_scale"], ja[f"{name}_scale"]
        assert ((ts - js).abs() <= 2 ** -6 * js.abs()).all(), name
        if kv_dtype == "int8":
            assert (ta[name] - ja[name]).abs().max() <= 2, name
        else:
            deq, jdeq = ts[..., None] * ta[name], js[..., None] * ja[name]
            assert ((deq - jdeq).abs() <= 2 * 32 * js[..., None]).all(), name
