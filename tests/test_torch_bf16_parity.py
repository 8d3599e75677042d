"""PyTorch port vs the JAX reference in bf16, bit for bit.

The f32 twins of these tests (`test_torch_serve.py`, `test_torch_moe.py`,
`test_torch_hybrid.py`, `test_torch_contiguous_engine.py`) hold the port
within 1e-5; here, at TINY in bf16 (compute and params), the port must
equal the reference exactly: the same logits and arena bits, the same
event streams, stats and caches.

The reference runs without XLA's excess precision (which otherwise
keeps some bf16 intermediates of a fused computation in f32 on the
CPU): step functions are compiled with
`xla_allow_excess_precision=False`, and the engines, which jit inside,
run in one subprocess with `XLA_FLAGS=--xla_allow_excess_precision=false`
that computes every reference stream of this module and writes them to
an `.npz`.  The subprocess also ships its params, so both sides start
from the same bits.

What makes the port equal: `models.layers.silu` (the reference's
`jax.nn.silu` rounding in bf16), `models.layers.matmul` (a weight
projection as XLA's bf16 dot: an f32 product rounded once) and the
paged plain versions' `round_scores` (the reference oracles' q.k in
q's dtype)."""
from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import TINY
from repro.kernels.paged_attention.ref import paged_decode_attention_ref
from repro.kernels.paged_prefill.ref import paged_prefill_attention_ref
from repro.models import hybrid as JH
from repro.models import moe as JM
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
from repro_torch.models import hybrid as PH
from repro_torch.models import layers as L
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_moe import run_paged_steps
from torch_port_helpers import port_cfg, port_params, tensor_to_numpy

ROOT = Path(__file__).resolve().parents[1]
NO_EXCESS = {"xla_allow_excess_precision": False}
REFERENCE_TIMEOUT_S = 600


def bf16(cfg):
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16")


def bits(a) -> np.ndarray:
    """Raw bits of a bf16 array (jax, ml_dtypes numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return tensor_to_numpy(a)
    return np.asarray(a).view(np.uint16)


# ------------------------------------------------------------------ silu

def _jax_silu_bits(x: torch.Tensor) -> np.ndarray:
    xj = jnp.asarray(bits(x).view(jnp.bfloat16))
    return bits(jax.jit(jax.nn.silu)(xj))


def test_silu_is_bit_exact_with_jax_in_bf16():
    """Every bf16 value whose computation stays in normal floats, and
    200,000 normal draws: the same bits as `jax.nn.silu`.  Where a
    subnormal appears (the input, 1 / (1 + exp(-x)) below x ~ -87, or
    the product), XLA's CPU flushes it to zero and torch does not: the
    two may differ there, and only there, with the reference at 0."""
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    every = every[torch.isfinite(every)]
    rng = np.random.default_rng(0)
    draws = torch.from_numpy(
        (rng.standard_normal(200_000) * 4).astype(np.float32)).bfloat16()
    x = torch.cat([every, draws])
    got, want = bits(L.silu(x)), _jax_silu_bits(x)
    assert L.silu(x).dtype == torch.bfloat16

    tiny = np.finfo(np.float32).tiny
    xf = x.float().numpy()
    with np.errstate(over="ignore"):
        logistic = 1.0 / (1.0 + np.exp(-xf.astype(np.float64)))
    normal = ((xf == 0) | (np.abs(xf) >= 2 * tiny)) & (logistic >= tiny)
    assert normal.sum() > 100_000
    np.testing.assert_array_equal(got[normal], want[normal])
    differ = got != want
    assert not (differ & normal).any()
    assert (want[differ].view(jnp.bfloat16).astype(np.float32) == 0).all()
    # the port's earlier F.silu rounds once and differs from the reference
    assert (bits(F.silu(x))[normal] != want[normal]).mean() > 0.2


# ------------------------------------------------------------------ gelu

def test_gelu_is_bit_exact_with_jax_in_bf16():
    """Every finite bf16 value and 200,000 draws of 3 N(0, 1): the same
    bits as `jax.nn.gelu` (tanh approximation) wherever the input and
    the result (about x / 2 near 0) are normal floats.  Below that, XLA's
    CPU flushes the subnormal to zero and torch does not: the two may
    differ there, and only there, with the reference at 0.  f32 keeps
    `F.gelu`."""
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    every = every[torch.isfinite(every)]
    rng = np.random.default_rng(0)
    draws = torch.from_numpy(
        (rng.standard_normal(200_000) * 3).astype(np.float32)).bfloat16()
    x = torch.cat([every, draws])
    xj = jnp.asarray(bits(x).view(jnp.bfloat16))
    got, want = bits(L.gelu(x)), bits(jax.jit(jax.nn.gelu)(xj))
    assert L.gelu(x).dtype == torch.bfloat16

    xf = x.float().numpy()
    normal = (xf == 0) | (np.abs(xf) >= 4 * np.finfo(np.float32).tiny)
    assert normal.sum() > 200_000
    np.testing.assert_array_equal(got[normal], want[normal])
    differ = got != want
    assert not (differ & normal).any()
    assert (want[differ].view(jnp.bfloat16).astype(np.float32) == 0).all()
    # F.gelu rounds once and differs from the reference
    assert (bits(F.gelu(x, approximate="tanh"))[normal]
            != want[normal]).mean() > 0.2
    f = torch.from_numpy(rng.standard_normal(1000).astype(np.float32) * 3)
    assert torch.equal(L.gelu(f), F.gelu(f, approximate="tanh"))


def test_silu_is_f_silu_in_f32():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(10_000) * 4).astype(np.float32))
    assert torch.equal(L.silu(x), F.silu(x))
    np.testing.assert_allclose(L.silu(x).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- weight projections

PROJECTIONS = ("wq", "wk", "wv", "wo", "wg", "wi", "router", "in_proj",
               "out_proj", "group_proj", "head")


@functools.cache
def projection_shapes() -> list[tuple[int, int]]:
    """(d_in, d_out) of every weight projection of the TINY dense, moe,
    ssm and hybrid families (their stacked leaves' last two axes), and
    the tied logits' (d_model, vocab)."""
    shapes = set()
    for name in ("dense", "moe", "ssm", "hybrid"):
        cfg = TINY[name]
        jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            if path[-1].key in PROJECTIONS:
                shapes.add(tuple(leaf.shape[-2:]))
        shapes.add((cfg.d_model, cfg.vocab_size))
    return sorted(shapes)


@pytest.mark.parametrize("rows", [(4, 8), (3,), (4, 2), (4, 3), (4, 5)],
                         ids=["chunk", "decode", "verify_k1", "verify_k2",
                              "verify_k4"])
def test_matmul_is_bit_exact_with_jax_at_the_tiny_projections(rows):
    """`layers.matmul` in bf16 on the CPU gives the bits of XLA's bf16
    dot (`jax.jit(a @ b)`) at every TINY projection shape, for a
    prefill chunk's rows, a decode step's, and a speculative verify
    chunk's (4 rows of k + 1 at k = 1, 2, 4: the projections and the
    all-position logits); in f32 it is `x @ w`."""
    dot = jax.jit(lambda a, b: a @ b)
    rng = np.random.default_rng(5)
    assert len(projection_shapes()) >= 7
    for d_in, d_out in projection_shapes():
        for _ in range(3):
            x = rng.standard_normal((*rows, d_in)).astype(np.float32)
            w = (rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32)
            xt, wt = torch.from_numpy(x), torch.from_numpy(w)
            got = L.matmul(xt.bfloat16(), wt.bfloat16())
            assert got.dtype == torch.bfloat16
            want = dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
            np.testing.assert_array_equal(bits(got), bits(want),
                                          err_msg=f"{(d_in, d_out)}")
            assert torch.equal(L.matmul(xt, wt), xt @ wt)


# --------------------------------------------------------- score rounding

def _paged_inputs(seed, dtype, c=None, b=3, hkv=2, g=2, d=32, page=8, mp=4):
    """bf16-exact q, pages and a block table with ragged rows; `c`
    chunk rows (prefill) or one query per row (decode)."""
    rng = np.random.default_rng(seed)
    P = b * mp
    shape = (b, c, g * hkv, d) if c else (b, g * hkv, d)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (shape, (P + 1, page, hkv, d), (P + 1, page, hkv, d))]
    arrays = [np.asarray(jnp.asarray(a, dtype)) for a in arrays]
    bt = rng.permutation(P).astype(np.int32).reshape(b, mp)
    return arrays, bt


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("partials", [False, True])
def test_round_scores_matches_the_reference_oracles(kind, partials):
    """bf16: `round_scores=True` gives the oracle's bits (its f32
    partials within 1e-6); without it the plain version differs, as the
    CUDA kernels' oracle is meant to.  f32: the keyword is the
    identity."""
    c = 5 if kind == "prefill" else None
    (q, k, v), bt = _paged_inputs(3, jnp.bfloat16, c)
    if kind == "prefill":
        start = np.array([0, 9, 20], np.int32)
        clen = np.array([5, 3, 0], np.int32)
        geometry = (start, clen)
        ref, plain = paged_prefill_attention_ref, pp.paged_prefill_attention_plain
    else:
        geometry = (np.array([31, 0, 17], np.int32),)
        ref, plain = paged_decode_attention_ref, pa.paged_decode_attention_plain
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, *geometry)]
    f = jax.jit(lambda *a: ref(*a, partials=partials))
    want = f.lower(*jargs).compile(compiler_options=NO_EXCESS)(*jargs)
    targs = [torch.from_numpy(bits(a).copy()).view(torch.bfloat16)
             for a in (q, k, v)] + [torch.from_numpy(a) for a in (bt, *geometry)]
    got = plain(*targs, partials=partials, round_scores=True)
    off = plain(*targs, partials=partials)
    if partials:
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        assert any((o != g_).any() for o, g_ in zip(off, got))
    else:
        np.testing.assert_array_equal(bits(got), bits(want))
        assert (bits(off) != bits(got)).any()
    f32 = [t.float() if t.is_floating_point() else t for t in targs]
    out = [plain(*f32, partials=partials, round_scores=r)
           for r in (False, True)]
    for a, b_ in zip(*(o if partials else (o,) for o in out)):
        assert torch.equal(a, b_)


def test_cpu_dispatchers_round_the_scores_and_cuda_oracle_does_not():
    (q, k, v), bt = _paged_inputs(4, jnp.bfloat16)
    t = [torch.from_numpy(bits(a).copy()).view(torch.bfloat16)
         for a in (q, k, v)]
    pos = torch.tensor([31, 2, 17], dtype=torch.int32)
    args = (*t, torch.from_numpy(bt), pos)
    assert torch.equal(pa.paged_decode_attention(*args),
                       pa.paged_decode_attention_plain(*args,
                                                       round_scores=True))
    assert not torch.equal(pa.paged_decode_attention(*args),
                           pa.paged_decode_attention_plain(*args))


# ------------------------------------------------------------ paged steps

class _NoExcess:
    """A reference family whose step functions are compiled with excess
    precision off."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        f = getattr(self.mod, name)
        if name not in ("paged_prefill", "paged_decode_step"):
            return f

        def call(params, cfg, *a):
            compiled = jax.jit(lambda p, *x: f(p, cfg, *x)).lower(
                params, *a).compile(compiler_options=NO_EXCESS)
            return compiled(params, *a)
        return call


class _F32Logits:
    """A port family whose step functions return f32 logits (bf16 ->
    f32 is exact, so equal floats are equal bits)."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        f = getattr(self.mod, name)
        if name not in ("paged_prefill", "paged_decode_step"):
            return f

        def call(*a):
            arena, logits = f(*a)
            return arena, logits.float()
        return call


STEP_CASES = {"dense": (JT, PT, TINY["dense"]),
              "moe-scatter": (JM, PM, TINY["moe"]),
              "moe-grouped": (JM, PM, TINY["moe"].replace(
                  moe_dispatch="grouped")),
              "hybrid-xla": (JH, PH, TINY["hybrid"]),
              "hybrid-pallas": (JH, PH, TINY["hybrid"].replace(
                  ssd_impl="pallas"))}

@functools.cache
def paged_steps(case):
    """`run_paged_steps` (two ragged prefill chunks and a decode step)
    of STEP_CASES[case] in bf16, the reference without excess
    precision; the port's logits as f32 (bf16 -> f32 is exact, so
    equal floats are equal bits)."""
    JF, PF, cfg = STEP_CASES[case]
    cfg = bf16(cfg)
    jp = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    return run_paged_steps(_NoExcess(JF), _F32Logits(PF), cfg, jp,
                           port_params(jp, cfg),
                           max_batch=4 if cfg.family == "hybrid" else 0)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_paged_step_logits_match_reference_in_bf16(case):
    """Live rows' logits of both prefill chunks and the decode step are
    bit-identical."""
    steps, _, _, _ = paged_steps(case)
    for jl, tl, live in steps:
        assert jl.dtype == jnp.bfloat16
        np.testing.assert_array_equal(tl[live], jl[live].astype(np.float32))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_paged_step_arena_matches_reference_in_bf16(case):
    """Every non-null page and the hybrid's conv/SSM state rows are
    bit-identical after the steps."""
    _, ja, ta, P = paged_steps(case)
    assert sorted(ta) == sorted(ja)
    for name in ("conv", "ssm"):
        if name in ta:
            np.testing.assert_array_equal(bits(ta[name]), bits(ja[name]),
                                          err_msg=name)
    for name in ("k", "v"):                       # the null slot is garbage
        np.testing.assert_array_equal(bits(ta[name][:, :P]),
                                      bits(ja[name])[:, :P], err_msg=name)


# ------------------------------------------------- engine twins (helpers)
#
# test_torch_bf16_paged_engine.py and test_torch_bf16_contiguous_engine.py
# hold the engines: one reference subprocess per module (`reference`).

PAGED_ENGINE_CFG = {"dense": TINY["dense"],
                    "moe": TINY["moe"].replace(moe_dispatch="grouped"),
                    "hybrid": TINY["hybrid"].replace(ssd_impl="pallas"),
                    # its requests carry `test_torch_serve.image_rows`
                    "vlm": TINY["vlm"]}
# the speculating engine's cases: (family, scenario) -> (k, draft)
SPEC_CASES = {("dense", "chunked"): (2, "self:1"),
              ("dense", "preempt"): (4, "self:1"),
              ("moe", "chunked"): (2, "self:1")}
ENGINE_CASES = {
    "paged": [(f, s) for f in PAGED_ENGINE_CFG
              for s in ("chunked", "preempt")],
    "contiguous": [(f, s) for f in ("dense", "moe", "hybrid", "ssm")
                   for s in ("mixed", "idle_past_max_seq")],
    "speculative": list(SPEC_CASES)}


def engine_cfg(layout, family):
    return bf16(TINY[family] if layout == "contiguous"
                else PAGED_ENGINE_CFG[family])


def params_key(cfg) -> str:
    return f"{cfg.name}-{cfg.moe_dispatch}-{cfg.ssd_impl}"


class _BitsCache:
    """An engine whose `cache` leaves read as numpy bits, so the
    contiguous `_drive` can copy a bf16 torch cache."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    @property
    def cache(self):
        return {k: tensor_to_numpy(v) for k, v in self._engine.cache.items()}


def drive(side, layout, family, scenario, params):
    """One engine run of `side` ("reference" or "port") through the f32
    twins' `_drive` and `_scenario`: (events, stats) for the paged layout
    (also speculating: `SPEC_CASES`), plus (cache bits, top position)
    for the contiguous one."""
    cfg = engine_cfg(layout, family)
    if layout != "contiguous":
        from test_torch_serve import _drive, _scenario
        kw, script = _scenario(scenario, cfg.vocab_size)
        if layout == "speculative":
            kw["speculate_k"], kw["draft"] = SPEC_CASES[(family, scenario)]
    else:
        from test_torch_contiguous_engine import _drive, _scenario
        kw, script = _scenario(scenario, cfg.vocab_size)
        kw["layout"] = "contiguous"
    if side == "reference":
        from repro.serve import ServingEngine as JaxEngine
        from repro.serve.engine import Request as JaxRequest
        from repro.serve.sampling import SamplingParams as JaxSP
        engine, request_cls, sp_cls = JaxEngine(cfg, params, **kw), \
            JaxRequest, JaxSP
    else:
        engine = ServingEngine(port_cfg(cfg), params, device="cpu", **kw)
        request_cls, sp_cls = Request, SamplingParams
    if layout != "contiguous":
        return _drive(engine, request_cls, script)
    if side == "port":
        engine = _BitsCache(engine)
    log, stats, cache, top = _drive(engine, request_cls, sp_cls, script)
    cache = {k: v.view(np.uint16) if v.dtype.itemsize == 2 else v
             for k, v in cache.items()}
    return log, stats, cache, top


def write_reference(path, layout):
    """Every reference engine run of `layout`'s cases (and the params it
    used, as numpy) into the .npz at `path`; run with excess precision
    off."""
    assert "--xla_allow_excess_precision=false" in os.environ.get(
        "XLA_FLAGS", "")
    params, runs = {}, {}
    for family, scenario in ENGINE_CASES[layout]:
        cfg = engine_cfg(layout, family)
        key = params_key(cfg)
        if key not in params:
            params[key] = jax.tree.map(np.asarray, jax_registry.get_family(
                cfg).init(jax.random.key(0), cfg))
        runs[(family, scenario)] = drive(
            "reference", layout, family, scenario,
            jax.tree.map(jnp.asarray, params[key]))
    blob = pickle.dumps({"params": params, "runs": runs})
    np.savez(path, blob=np.frombuffer(blob, np.uint8))


def reference_runs(layout, tmp_dir):
    """Run `write_reference` in a subprocess with
    `XLA_FLAGS=--xla_allow_excess_precision=false` and load its runs."""
    path = tmp_dir / f"reference_{layout}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT / "tests")!r}]
        import test_torch_bf16_parity as m
        m.write_reference({str(path)!r}, {layout!r})
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=REFERENCE_TIMEOUT_S, cwd=ROOT,
                          env=env)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with np.load(path) as f:
        return pickle.loads(f["blob"].tobytes())


def port_run(reference, layout, family, scenario):
    """The port's run of a case, from the reference's params."""
    cfg = engine_cfg(layout, family)
    pp = port_params(reference["params"][params_key(cfg)], cfg)
    return drive("port", layout, family, scenario, pp)
