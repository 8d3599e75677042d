"""PyTorch port vs the JAX reference: the MoE family's paged serving.

The grouped-matmul kernel's plain version is held against the
reference's oracle and its Pallas kernel (interpret mode on the CPU,
as tests/test_kernels.py runs it); routing, the dropless dispatch, the
paged steps and the engine against `repro.models.moe` and
`repro.serve.ServingEngine` at TINY["moe"] in f32 with
`moe_dispatch="grouped"` (and "scatter", the einsum twin).  Tolerance
atol = rtol = 1e-5 unless a comment says otherwise; streams and pool
statistics are equal."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.kernels.grouped_matmul.kernel import grouped_matmul_pallas
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro.models import moe as JM
from repro.serve import ServingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.kernels.grouped_matmul import ops as gm
from repro_torch.models import moe as PM
from repro_torch.serve.engine import Request, ServingEngine
from test_torch_serve import _drive, _prompts, _scenario
from torch_port_helpers import (jax_family_params, np_tree, params_to_numpy,
                                port_cfg)

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def moe():
    cfg = TINY["moe"].replace(moe_dispatch="grouped")
    jp, pp = jax_family_params(cfg)
    return cfg, jp, pp


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ grouped matmul

@pytest.mark.parametrize("E, C, K, F", [(4, 8, 16, 32), (3, 128, 64, 128),
                                        (2, 37, 19, 45), (5, 200, 72, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_reference_oracle_and_pallas_kernel(E, C, K, F,
                                                                  dtype):
    rng = np.random.default_rng(E * C + K)
    x = jnp.asarray(rng.standard_normal((E, C, K)), dtype)
    w = jnp.asarray(rng.standard_normal((E, K, F)) * 0.1, dtype)
    got = gm.grouped_matmul_plain(_t(x.astype(jnp.float32)).to(
        getattr(torch, dtype)), _t(w.astype(jnp.float32)).to(
        getattr(torch, dtype))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(grouped_matmul_ref(x, w)),
                               **F32)
    tiled = all(n <= 128 or n % 128 == 0 for n in (C, K, F))
    if tiled:                       # the Pallas kernel's tiling constraint
        np.testing.assert_allclose(
            got, np.asarray(grouped_matmul_pallas(x, w, interpret=True)),
            **F32)


def test_grouped_rows_zero_the_rows_past_each_experts_count():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 24, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16, 8)).astype(np.float32))
    rows = torch.tensor([0, 5, 24, 30], dtype=torch.int32)  # 30 > C: all
    full = gm.grouped_matmul(x, w)
    got = gm.grouped_matmul(x, w, rows)
    keep = torch.arange(24)[None, :] < torch.clamp(rows, max=24)[:, None]
    want = torch.where(keep[..., None], full, torch.zeros(()))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[0].any() and not got[1, 5:].any()


@pytest.mark.parametrize("C", [8, 200])
def test_experts_apply_grouped_matches_reference(moe, C):
    cfg, jp, pp = moe
    rng = np.random.default_rng(C)
    buf = rng.standard_normal((cfg.num_experts, C, cfg.d_model)).astype(
        np.float32)
    want = JM.experts_apply_grouped(jax.tree.map(lambda a: a[0],
                                                 jp["layers"]["moe"]
                                                 ["experts"]),
                                    jnp.asarray(buf))
    got = PM.experts_apply_grouped(pp["layers"][0]["moe"]["experts"],
                                   torch.from_numpy(buf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    twin = PM.experts_apply(pp["layers"][0]["moe"]["experts"],
                            torch.from_numpy(buf))
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------- routing

def test_route_matches_reference(moe):
    cfg, jp, pp = moe
    rng = np.random.default_rng(4)
    xf = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    jw, je, _ = JM._route(jp["layers"]["moe"]["router"][1], cfg,
                          jnp.asarray(xf))
    tw, te = PM._route(pp["layers"][1]["moe"]["router"], port_cfg(cfg),
                       torch.from_numpy(xf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)


@pytest.mark.parametrize("dispatch", ["grouped", "scatter", "ep"])
def test_moe_apply_dropless_matches_reference(moe, dispatch):
    cfg, jp, pp = moe
    cfg = cfg.replace(moe_dispatch=dispatch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    want, _ = JM.moe_apply(jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
                           cfg, jnp.asarray(x), dropless=True)
    got = PM.moe_apply(pp["layers"][0]["moe"], port_cfg(cfg),
                       torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.moe_apply(pp["layers"][0]["moe"], port_cfg(cfg),
                     torch.from_numpy(x))


# ---------------------------------------------------------- paged steps

def _paged_case(cfg, seed=0):
    """Shuffled pages, ragged rows and an inert row (b 4, page 8)."""
    page, P, mp, b = 8, 16, 8, 4
    rng = np.random.default_rng(seed)
    bt = np.full((b, mp), P, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    for i, n in enumerate((3, 2, 4, 0)):
        bt[i, :n] = perm[4 * i:4 * i + n]
    return rng, page, P, b, bt


def run_paged_steps(JF, PF, cfg, jp, pp, seed=0, max_batch=0):
    """Two prefill chunks (the second at a nonzero start, with a ragged
    row, an inert row and bucket tails) and a decode step with an
    inactive row, through the reference family JF and the port's PF.
    Returns [(reference logits, port logits, live rows)] and both
    arenas."""
    pc = port_cfg(cfg)
    rng, page, P, b, bt = _paged_case(cfg, seed)
    ja = JF.init_paged_cache(cfg, P + 1, page, max_batch)
    ta = PF.init_paged_cache(pc, P + 1, page, max_batch=max_batch,
                             device="cpu")
    out = []
    for start, clen in ((np.array([0, 0, 0, 0]), np.array([8, 5, 8, 0])),
                        (np.array([8, 5, 8, 0]), np.array([8, 3, 0, 0]))):
        tokens = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
        ja, jl = JF.paged_prefill(
            jp, cfg, {"tokens": jnp.asarray(tokens)}, ja, jnp.asarray(bt),
            jnp.asarray(start, jnp.int32), jnp.asarray(clen, jnp.int32))
        ta, tl = PF.paged_prefill(
            pp, pc, {"tokens": torch.from_numpy(tokens)}, ta,
            torch.from_numpy(bt), torch.from_numpy(start.astype(np.int32)),
            torch.from_numpy(clen.astype(np.int32)))
        out.append((np.asarray(jl), tl.numpy(), clen > 0))
    positions = np.array([16, 8, 8, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    ja, jl = JF.paged_decode_step(jp, cfg, ja, jnp.asarray(bt),
                                  jnp.asarray(positions), jnp.asarray(tokens))
    ta, tl = PF.paged_decode_step(pp, pc, ta, torch.from_numpy(bt),
                                  torch.from_numpy(positions),
                                  torch.from_numpy(tokens))
    out.append((np.asarray(jl), tl.numpy(), positions > 0))
    return out, ja, ta, P


@pytest.mark.parametrize("dispatch", ["grouped", "scatter"])
def test_paged_steps_logits_and_arena_match_reference(moe, dispatch):
    cfg, jp, pp = moe
    cfg = cfg.replace(moe_dispatch=dispatch)
    steps, ja, ta, P = run_paged_steps(JM, PM, cfg, jp, pp)
    for jl, tl, live in steps:
        np.testing.assert_allclose(tl[live], jl[live], **F32)
    assert sorted(ta) == sorted(ja)
    for name in ("k", "v"):                       # the null slot is garbage
        np.testing.assert_allclose(ta[name][:, :P].numpy(),
                                   np.asarray(ja[name])[:, :P], **F32)


# ----------------------------------------------------------- params

def test_bridge_round_trips_moe_params_bit_exact(moe):
    cfg, jp, pp = moe
    back = params_to_numpy(pp, cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(np_tree(jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b) and "shared" in pp["layers"][0]["moe"]
    for path, w in flat_w:
        assert flat_b[path].dtype == w.dtype, path
        np.testing.assert_array_equal(flat_b[path], w, err_msg=str(path))


def test_port_init_matches_reference_names_shapes_and_std():
    cfg = TINY["moe"].replace(d_model=128, num_experts=8, moe_d_ff=128)
    jp = np_tree(JM.init(jax.random.key(0), cfg))
    pp = params_to_numpy(PM.init(0, port_cfg(cfg), "cpu"), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert sorted(map(str, flat_p)) == sorted(str(p) for p, _ in flat_j)
    for path, w in flat_j:
        got = flat_p[path]
        assert got.shape == w.shape and got.dtype == w.dtype, path
        # same law, different draws: stds of >= 8k values within 5%
        np.testing.assert_allclose(got.std(), w.std(), rtol=5e-2,
                                   err_msg=str(path))


# ----------------------------------------------------------- engine

def engine_scenario(name, vocab):
    """The dense scenarios plus `twins`: two identical prompts admitted
    together, then a third sharing their first two pages."""
    if name != "twins":
        return _scenario(name, vocab)
    ps = _prompts(7, (29, 18), vocab)
    third = np.concatenate([ps[0][:16], ps[1]])
    kw = dict(max_batch=4, max_seq=64, page_size=8, prefill_chunk=8)
    return kw, {0: [("submit", 0, ps[0], 5), ("submit", 1, ps[0], 5)],
                4: [("submit", 2, third, 4)]}


@pytest.mark.parametrize("name", ["chunked", "preempt",
                                  "fork_cancel_budget", "twins"])
def test_engine_streams_and_stats_match_reference(moe, name):
    cfg, jp, pp = moe
    kw, script = engine_scenario(name, cfg.vocab_size)
    want = _drive(JaxEngine(cfg, jp, **kw), JaxRequest, script)
    got = _drive(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
                 Request, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # incl. peak_kv_bytes
    assert got[1]["pool"]["allocated_pages"] == 0
    if name == "preempt":
        assert got[1]["preemptions"] > 0
    if name in ("chunked", "twins"):
        assert got[1]["prefix_store"]["reused_pages"] > 0
