"""PyTorch port vs the JAX reference: the SSD kernel's plain version,
the Mamba-2 blocks and the hybrid family's paged serving.

The SSD plain version is held against the reference's oracle and its
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs
it); `ssd_chunked`, the recurrences, the block bodies, the paged steps
(logits, pages AND conv/SSM state) and the engine against
`repro.models.mamba2`, `repro.models.hybrid` and
`repro.serve.ServingEngine` at TINY["hybrid"] in f32 with
`ssd_impl="pallas"` (and "xla").  Tolerance atol = rtol = 1e-5 unless a
comment says otherwise; streams and pool statistics are equal."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_pallas
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro.models import hybrid as JH
from repro.models import mamba2 as JM2
from repro.serve import ServingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import hybrid as PH
from repro_torch.models import mamba2 as PM2
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.kv_cache import STATE_SLOT_AXIS, PagedKVArena
from test_torch_moe import engine_scenario, run_paged_steps
from test_torch_serve import _drive
from torch_port_helpers import (jax_family_params, np_tree, params_to_numpy,
                                port_cfg)

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def hybrid():
    cfg = TINY["hybrid"].replace(ssd_impl="pallas")
    jp, pp = jax_family_params(cfg)
    return cfg, jp, pp


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(rng, bh, nc, l, p, n):
    x = rng.standard_normal((bh, nc, l, p)).astype(np.float32)
    dt = (rng.random((bh, nc, l)) * 0.2).astype(np.float32)
    A = -np.linspace(0.5, 4.0, bh).astype(np.float32)
    B = rng.standard_normal((bh, nc, l, n)).astype(np.float32)
    C = rng.standard_normal((bh, nc, l, n)).astype(np.float32)
    return x, dt, A, B, C


# ------------------------------------------------------------- SSD kernel

@pytest.mark.parametrize("bh, nc, l, p, n", [(4, 2, 16, 32, 16),
                                             (3, 1, 13, 8, 24),
                                             (2, 3, 64, 64, 64)])
def test_ssd_plain_matches_reference_oracle_and_pallas_kernel(bh, nc, l, p,
                                                              n):
    ins = _ssd_inputs(np.random.default_rng(l), bh, nc, l, p, n)
    got = ssd.ssd_intra_chunk_plain(*map(torch.from_numpy, ins))
    ref = ssd_intra_chunk_ref(*map(jnp.asarray, ins))
    pal = ssd_intra_chunk_pallas(*map(jnp.asarray, ins), interpret=True)
    for g, r, k in zip(got, ref, pal):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(k), **F32)


def test_ssd_plain_rounds_where_the_tpu_kernel_casts_in_bf16():
    """In bf16 the plain version rounds the scores and the decayed x to
    bf16 as `_ssd_kernel` does; the Pallas kernel in interpret mode
    agrees within the bf16 rounding of its f32 dot products (1e-2 of
    the row's largest value, kernels/tolerance.py's rule)."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(1), 3, 2, 16, 16, 16)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, B, C)]
    pal = ssd_intra_chunk_pallas(jb[0], jnp.asarray(dt), jnp.asarray(A),
                                 jb[1], jb[2], interpret=True)
    tb = [_t(a.astype(jnp.float32)).bfloat16() for a in jb]
    got = ssd.ssd_intra_chunk_plain(tb[0], torch.from_numpy(dt),
                                    torch.from_numpy(A), tb[1], tb[2])
    for g, k in zip(got, pal):
        k = np.asarray(k)
        bound = 1e-2 * np.abs(k) + 1e-2 * np.abs(k).max(-1, keepdims=True)
        assert (np.abs(g.numpy() - k) <= bound).all()


# ----------------------------------------------------------------- SSD

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s, chunk, init", [(32, 16, False), (27, 8, True),
                                            (5, 16, True)])
def test_ssd_chunked_matches_reference(impl, s, chunk, init):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.3).astype(np.float32)
    A = -np.linspace(0.5, 3.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    jy, jS = JM2.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                             None if s0 is None else jnp.asarray(s0),
                             impl=impl)
    ty, tS = PM2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                             None if s0 is None else torch.from_numpy(s0),
                             impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **F32)


def test_ssd_step_and_causal_conv_step_match_reference():
    rng = np.random.default_rng(2)
    b, h, p, n, w, ch = 3, 4, 8, 16, 4, 24
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = rng.random((b, h)).astype(np.float32)
    A = -np.linspace(1, 4, h).astype(np.float32)
    B = rng.standard_normal((b, h, n)).astype(np.float32)
    C = rng.standard_normal((b, h, n)).astype(np.float32)
    for j, t in zip(JM2.ssd_step(*map(jnp.asarray, (state, x, dt, A, B, C))),
                    PM2.ssd_step(*map(torch.from_numpy,
                                      (state, x, dt, A, B, C)))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
    cw = rng.standard_normal((w, ch)).astype(np.float32)
    cb = rng.standard_normal((ch,)).astype(np.float32)
    cache = rng.standard_normal((b, w - 1, ch)).astype(np.float32)
    xn = rng.standard_normal((b, ch)).astype(np.float32)
    for j, t in zip(JM2.causal_conv_step(*map(jnp.asarray,
                                              (cw, cb, cache, xn))),
                    PM2.causal_conv_step(*map(torch.from_numpy,
                                              (cw, cb, cache, xn)))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_block_prefill_chunk_and_block_step_match_reference(hybrid, impl):
    cfg, jp, pp = hybrid
    cfg = cfg.replace(ssd_impl=impl)
    pc = port_cfg(cfg)
    jmix = jax.tree.map(lambda a: a[1, 0], jp["mamba"]["mixer"])
    tmix = pp["mamba"][1][0]["mixer"]
    rng = np.random.default_rng(3)
    b, c = 4, 20                                 # c > ssm_chunk: 2 chunks
    u = rng.standard_normal((b, c, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, cfg.conv_channels)
                               ).astype(np.float32)
    ssm = rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state)).astype(np.float32) * 0.1
    valid = np.arange(c)[None, :] < np.array([20, 7, 1, 0])[:, None]
    want = JM2.block_prefill_chunk(jmix, cfg, *map(jnp.asarray,
                                                   (u, conv, ssm, valid)))
    got = PM2.block_prefill_chunk(tmix, pc, *map(torch.from_numpy,
                                                 (u, conv, ssm, valid)))
    for j, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
    # the empty row's tail and state come back untouched
    np.testing.assert_array_equal(got[1][3].numpy(), conv[3])
    want = JM2.block_step(jmix, cfg, *map(jnp.asarray, (u[:, 0], conv, ssm)))
    got = PM2.block_step(tmix, pc, *map(torch.from_numpy,
                                        (u[:, 0], conv, ssm)))
    for j, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)


# ------------------------------------------------------------ paged steps

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_steps_logits_pages_and_state_match_reference(hybrid, impl):
    """Rows starting at 0 and continuing, a row with chunk_len 0 (whose
    state must survive), an inactive decode row: logits, pages and the
    conv/SSM state rows all agree."""
    cfg, jp, pp = hybrid
    cfg = cfg.replace(ssd_impl=impl)
    steps, ja, ta, P = run_paged_steps(JH, PH, cfg, jp, pp, max_batch=4)
    for jl, tl, live in steps:
        np.testing.assert_allclose(tl[live], jl[live], **F32)
    assert sorted(ta) == sorted(ja)
    for name in ("k", "v"):                       # the null slot is garbage
        np.testing.assert_allclose(ta[name][:, :P].numpy(),
                                   np.asarray(ja[name])[:, :P], **F32)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(ta[name].numpy(), np.asarray(ja[name]),
                                   **F32)
    # row 3 never advanced: its state rows are still zero
    assert not ta["ssm"][:, :, 3].any() and ta["ssm"][:, :, 2].any()


def test_arena_state_bytes_and_slot_state_copy_match_reference(hybrid):
    from repro.serve.kv_cache import PagedKVArena as JaxArena
    cfg, _, _ = hybrid
    ja = JaxArena(cfg, num_pages=8, page_size=4, max_batch=3)
    ta = PagedKVArena(port_cfg(cfg), num_pages=8, page_size=4,
                      device="cpu", max_batch=3)
    assert (ta.bytes, ta.page_bytes, ta.state_bytes) == (
        ja.bytes, ja.page_bytes, ja.state_bytes)
    assert ta.state_bytes > 0
    for name in ("conv", "ssm"):
        ta.kv[name].normal_()
    before = {n: a.clone() for n, a in ta.kv.items()}
    ta.copy_slot_state(0, 2)
    for name, a in ta.kv.items():
        if name in ("k", "v"):
            assert torch.equal(a, before[name])
            continue
        assert torch.equal(a.select(STATE_SLOT_AXIS, 2),
                           before[name].select(STATE_SLOT_AXIS, 0))
        assert torch.equal(a.select(STATE_SLOT_AXIS, 1),
                           before[name].select(STATE_SLOT_AXIS, 1))


# ----------------------------------------------------------------- params

def test_bridge_round_trips_hybrid_params_bit_exact(hybrid):
    cfg, jp, pp = hybrid
    assert len(pp["mamba"]) == 2 and len(pp["mamba"][0]) == 2
    assert len(pp["shared"]) == 2 and len(pp["group_proj"]) == 2
    back = params_to_numpy(pp, cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(np_tree(jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, w in flat_w:
        assert flat_b[path].dtype == w.dtype, path
        np.testing.assert_array_equal(flat_b[path], w, err_msg=str(path))


def test_port_init_matches_reference_names_shapes_and_std():
    cfg = TINY["hybrid"].replace(d_model=128, d_ff=256)
    jp = np_tree(JH.init(jax.random.key(0), cfg))
    pp = params_to_numpy(PH.init(0, port_cfg(cfg), "cpu"), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert sorted(map(str, flat_p)) == sorted(str(p) for p, _ in flat_j)
    for path, w in flat_j:
        got = flat_p[path]
        assert got.shape == w.shape and got.dtype == w.dtype, path
        # same law, different draws: stds within 5%, means within four
        # standard errors; constant leaves (norms, A_log, D, biases)
        # equal within float rounding
        np.testing.assert_allclose(got.std(), w.std(), rtol=5e-2, atol=1e-6,
                                   err_msg=str(path))
        np.testing.assert_allclose(
            got.mean(), w.mean(), rtol=1e-5,
            atol=4 * w.std() / np.sqrt(w.size) + 1e-6, err_msg=str(path))


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("name", ["chunked", "preempt",
                                  "fork_cancel_budget", "twins"])
def test_engine_streams_and_stats_match_reference(hybrid, name):
    """Greedy streams, stats and peak_kv_bytes (pages plus the state
    rows) equal the reference engine's.  Identical prompts share pages
    but recompute every token (the prefill-token count shows it), and a
    fork's child decodes from the parent's copied state."""
    cfg, jp, pp = hybrid
    kw, script = engine_scenario(name, cfg.vocab_size)
    want = _drive(JaxEngine(cfg, jp, **kw), JaxRequest, script)
    got = _drive(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
                 Request, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]
    assert got[1]["pool"]["allocated_pages"] == 0
    if name == "twins":
        assert got[1]["prefix_store"]["reused_pages"] > 0
        # every prompt token computed: 29 + 29 + 34, nothing skipped
        assert got[1]["prefill_tokens"] == 92
    if name == "preempt":
        assert got[1]["preemptions"] > 0
