"""The grouped-matmul and SSD intra-chunk backwards of the port: each
plain version against autograd over its plain forward (partly live rows,
the SSD's dA and ddt), the autograd Functions on the CPU, the
forward-only launchers' refusal of grad-enabled inputs, and (marked
`cuda`, skipped without a card) the backward kernels against their plain
versions.

This file imports neither JAX nor the reference, so it also runs where
only PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_family_backward.py
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.grouped_matmul import ops as gm
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.tolerance import worst_ratio

# (E, C, K, F, rows): partly live experts, an empty one, one past C
GM_CASES = {
    "partly_live": (4, 24, 16, 40, (0, 5, 24, 17)),
    "over_capacity": (3, 16, 24, 8, (16, 40, 1)),
    "all_rows": (2, 9, 8, 16, None),
}
# (bh, nc, l, p, n)
SSD_CASES = {
    "two_chunks": (3, 2, 16, 8, 8),
    "short_chunk": (2, 1, 5, 8, 16),
    "wide_state": (2, 2, 12, 16, 24),
}
# the backwards' arithmetic is f32 (sums in other orders than autograd's)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(rng, *shape, scale=1.0, dtype=torch.float64):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


def _gm_inputs(case, dtype=torch.float64, seed=0):
    E, C, K, F, rows = case
    rng = _rng(seed)
    x, w = _t(rng, E, C, K, dtype=dtype), _t(rng, E, K, F, scale=0.2,
                                             dtype=dtype)
    dy = _t(rng, E, C, F, dtype=torch.float32)
    r = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    return x, w, dy, r


def _ssd_inputs(case, dtype=torch.float64, seed=0):
    bh, nc, l, p, n = case
    rng = _rng(seed)
    x = _t(rng, bh, nc, l, p, dtype=dtype)
    B = _t(rng, bh, nc, l, n, scale=0.3, dtype=dtype)
    C = _t(rng, bh, nc, l, n, scale=0.3, dtype=dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (bh, nc, l))).to(dtype)
    A = torch.from_numpy(-rng.uniform(0.5, 4.0, (bh,))).to(dtype)
    dy = _t(rng, bh, nc, l, p, dtype=torch.float32)
    ds = _t(rng, bh, nc, n, p, dtype=torch.float32)
    return (x, dt, A, B, C), dy, ds


# ------------------------------------------------------------ grouped

@pytest.mark.parametrize("name", list(GM_CASES))
def test_grouped_backward_plain_equals_autograd(name):
    x, w, dy, rows = _gm_inputs(GM_CASES[name])
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gm.grouped_matmul_plain(xa, wa, rows), (xa, wa),
                               dy.double())
    got = gm.grouped_matmul_backward_plain(x.float(), w.float(), dy, rows)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), wt, **F32_TOL)
    if rows is not None:     # no gradient reaches a row past the live count
        live = torch.arange(x.shape[1])[None, :] < rows[:, None]
        assert not got[0][~live].any()


def test_grouped_backward_rounds_dy_to_bf16_once():
    """bf16: dy (f32, the forward's output type) is rounded to bf16 once
    and the products are exact f32 sums, the gradient the einsum twin's
    autograd sees (its output, hence its dy, is bf16)."""
    x, w, dy, rows = _gm_inputs(GM_CASES["partly_live"], torch.bfloat16)
    got = gm.grouped_matmul_backward_plain(x, w, dy, rows)
    rounded = dy.to(torch.bfloat16).float()
    want = gm.grouped_matmul_backward_plain(x.float(), w.float(), rounded, rows)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=0, atol=0)
    unrounded = gm.grouped_matmul_backward_plain(x.float(), w.float(), dy, rows)
    assert not torch.equal(got[1], unrounded[1])


def test_grouped_bf16_rounding_floor_admits_only_the_one_rounding():
    """The bf16 kernels store their f32 sums rounded to bf16 once: the
    plain version's sums so rounded pass TOLERANCE plus `bf16_rounding`
    (and not TOLERANCE alone), sums 1 % off fail it."""
    x, w, dy, rows = _gm_inputs(GM_CASES["partly_live"], torch.bfloat16)
    want = gm.grouped_matmul_backward_plain(x, w, dy, rows)
    tol = gm.TOLERANCE[torch.bfloat16]
    rounded = tuple(t.to(torch.bfloat16) for t in want)
    assert worst_ratio(rounded, want, *tol, floor=gm.bf16_rounding)[1] <= 1
    assert worst_ratio(rounded, want, *tol)[1] > 1
    off = tuple((t * 1.01).to(torch.bfloat16) for t in want)
    assert worst_ratio(off, want, *tol, floor=gm.bf16_rounding)[1] > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grouped_fn_carries_the_gradient_on_the_cpu(dtype):
    x, w, dy, rows = _gm_inputs(GM_CASES["partly_live"], dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = gm.GroupedMatmulFn.apply(xa, wa, rows)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (xa, wa), dy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gm.grouped_matmul_plain(xb, wb, rows),
                               (xb, wb), dy)
    for g, wt in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.double(), wt.double(), **F32_TOL)


# ----------------------------------------------- grouped bf16 design mirrors

_GMB_SRC = (Path(gm.__file__).resolve().parents[1] / "csrc"
            / "grouped_matmul_bwd.cu").read_text()


def test_grouped_bwd_geometry_mirrors_the_kernel_source():
    """ops.py's mirrors of the bf16 wgmma design against
    csrc/grouped_matmul_bwd.cu: the wg namespace's constants, the
    setmaxnreg budget, the pass bits, and the shared memory by the
    source's own formula and stated total."""
    wg = _GMB_SRC[_GMB_SRC.index("namespace wg {"):
                  _GMB_SRC.index("}  // namespace wg")]
    const = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)[,;]", wg)}
    consumers = const["kConsumers"]
    assert gm.BWD_THREADS == 128 * (consumers + 1)
    assert "constexpr int kTileM = 64 * kConsumers;" in wg
    assert (gm.BWD_TILE_M, gm.BWD_TILE_N) == (64 * consumers,
                                              const["kTileN"])
    assert (gm.BWD_STEP, gm.BWD_STAGES) == (const["kStep"],
                                            const["kStages"])
    # ptxas gives each of the block's threads 65536 / threads registers
    # at entry; setmaxnreg's counts must fit in that
    entry = 65536 // gm.BWD_THREADS // 8 * 8
    assert (128 * const["kProducerRegs"]
            + 128 * consumers * const["kConsumerRegs"]
            <= gm.BWD_THREADS * entry)
    passes = dict(re.findall(r"kPass(\w+) = (\d+)", _GMB_SRC))
    assert {k.lower(): int(v) for k, v in passes.items()} == gm.BWD_PASSES
    assert "kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;" in wg
    stage = 2 * gm.BWD_TILE_M * gm.BWD_STEP + 2 * gm.BWD_TILE_N * gm.BWD_STEP
    assert gm.bwd_smem_bytes() == (1024 + gm.BWD_STAGES * stage
                                   + 2 * gm.BWD_STAGES * 8) == 197_696
    assert "197,696 bytes" in wg and "4 x 49,152" in wg
    assert gm.bwd_blocks_per_sm() == 1         # and so the block fits an SM
    # the launch: one block an SM, at most one an item
    assert "dim3(items < sms ? items : sms)" in wg
    assert gm.bwd_grid(128, 320, 2048, 768, 132) == {"dx": 132, "dw": 132}
    assert gm.bwd_grid(2, 40, 64, 32, 132) == {"dx": 2, "dw": 2}


# (E, C, K, F, rows): qwen3's gate/up and down at its training capacity
# (a routing draw's live counts), and ragged shapes with empty experts
_ITEM_CASES = {
    "qwen3_gate_up": (128, 320, 2048, 768, "draw"),
    "qwen3_down": (128, 320, 768, 2048, "draw"),
    "ragged": (9, 200, 72, 40, (0, 1, 63, 64, 65, 127, 128, 129, 200)),
    "ragged_wide": (3, 70, 264, 296, (0, 70, 5)),
}


@pytest.mark.parametrize("name", list(_ITEM_CASES))
def test_grouped_bwd_work_items_cover_every_tile_once(name):
    """The persistent launches' items: every (expert, tile) of dX and
    dW exactly once over the blocks, each block's items in increasing
    (expert-major) order; the ring steps each item takes, zeros for an
    expert with no live row; the tiles cover every output element."""
    E, C, K, F, rows = _ITEM_CASES[name]
    if rows == "draw":
        rng = _rng(5)
        choice = np.argsort(rng.random((4096, E)), axis=1)[:, :8]
        rows = np.minimum(np.bincount(choice.ravel(), minlength=E), C)
    live = [int(r) for r in rows]
    for kind in ("dx", "dw"):
        items = gm.bwd_work_items(kind, E, C, K, F)
        experts = [it[0] for it in items]
        assert experts == sorted(experts)        # expert-major
        order = {it: i for i, it in enumerate(items)}
        assert len(order) == len(items)
        blocks = gm.bwd_block_items(kind, E, C, K, F, 132)
        assert len(blocks) == min(132, len(items))
        walked = [it for b in blocks for it in b]
        assert sorted(walked) == sorted(items) and len(walked) == len(items)
        for b in blocks:
            idx = [order[it] for it in b]
            assert idx == sorted(idx)
        # the tiles lie on the (BWD_TILE_M, BWD_TILE_N) grid of each
        # expert's output, every cell of it once
        m, n = (C, K) if kind == "dx" else (K, F)
        assert set(items) == {(e, m0, n0) for e in range(E)
                              for m0 in range(0, m, gm.BWD_TILE_M)
                              for n0 in range(0, n, gm.BWD_TILE_N)}
        steps = [gm.bwd_item_steps(kind, it, live[it[0]], F) for it in items]
        if kind == "dw":
            per_item = [-(-live[e] // 64) for e, _, _ in items]
            assert steps == per_item
        else:
            assert steps == [-(-F // 64) if r0 < live[e] else 0
                             for e, r0, _ in items]
        for e in range(E):
            if live[e] == 0:
                assert not any(s for it, s in zip(items, steps)
                               if it[0] == e)
    assert len(gm.bwd_work_items("dx", E, C, K, F)) == \
        E * -(-C // 128) * -(-K // 256)
    assert len(gm.bwd_work_items("dw", E, C, K, F)) == \
        E * -(-K // 128) * -(-F // 256)


def test_round_dy_plain_is_dy_in_bf16_on_the_live_rows():
    """The rounding pass's plain version: the live rows are
    `dy.to(bfloat16)` bit for bit (round to nearest even, exact ties
    included), the rows past the live count zeros; it is the dy
    `grouped_matmul_backward_plain` multiplies."""
    E, C, F = 3, 10, 16
    dy = _t(_rng(3), E, C, F, dtype=torch.float32)
    # exact ties halfway between two bf16 values: 1 + 2^-8 rounds down
    # to 1 (even), 1 + 3 * 2^-8 up to 1 + 2^-6; and their negatives
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                         -(1 + 2.0 ** -8), -(1 + 3 * 2.0 ** -8)])
    dy[0, 0, :4] = ties
    rows = torch.tensor([4, 0, 10], dtype=torch.int32)
    got = gm.round_dy_plain(dy, rows)
    assert got.dtype == torch.bfloat16
    assert got[0, 0, :4].float().tolist() == [1.0, 1 + 2.0 ** -6, -1.0,
                                              -(1 + 2.0 ** -6)]
    live = torch.arange(C)[None, :] < rows[:, None]
    want = dy.to(torch.bfloat16)
    assert torch.equal(got[live].view(torch.int16), want[live].view(torch.int16))
    assert not got[~live].float().any()
    assert torch.equal(gm.round_dy_plain(dy), want)
    x, w, _, r = _gm_inputs(GM_CASES["partly_live"], torch.bfloat16)
    dy = _t(_rng(4), *x.shape[:2], w.shape[2], dtype=torch.float32)
    rounded = gm.round_dy_plain(dy, r).float()
    for g, wt in zip(gm.grouped_matmul_backward_plain(x, w, dy, r),
                     gm.grouped_matmul_backward_plain(x.float(), w.float(),
                                                      rounded, r)):
        torch.testing.assert_close(g, wt, rtol=0, atol=0)


# ---------------------------------------------------------------- SSD

def _ssd_forward_f64(x, dt, A, B, C):
    """(y_intra, s_chunk) of the SSD intra-chunk function in f64 (the
    plain forward computes in f32)."""
    seg = torch.cumsum(dt * A[:, None, None], dim=2)
    l = x.shape[2]
    mask = torch.ones((l, l), dtype=torch.bool).tril()
    L = torch.exp(torch.where(mask, seg[..., :, None] - seg[..., None, :],
                              torch.tensor(-torch.inf, dtype=x.dtype)))
    scores = torch.einsum("bcin,bcjn->bcij", C, B) * L * dt[..., None, :]
    w = torch.exp(seg[..., -1:] - seg) * dt
    return (torch.einsum("bcij,bcjp->bcip", scores, x),
            torch.einsum("bcjn,bcj,bcjp->bcnp", B, w, x))


def _ssd_autograd(inputs, dy, ds):
    leaves = [t.double().clone().requires_grad_() for t in inputs]
    y, s = _ssd_forward_f64(*leaves)
    return torch.autograd.grad((y * dy.double()).sum() + (s * ds.double()).sum(),
                               leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_backward_plain_equals_autograd(name, dtype):
    """dx, ddt, dA (summed over each batch*head's chunks), dB and dC; in
    f64 the plain version computes in f64 (the truth the kernel's f32
    sums are measured against)."""
    inputs, dy, ds = _ssd_inputs(SSD_CASES[name])
    want = _ssd_autograd(inputs, dy, ds)
    got = ssd.ssd_intra_chunk_backward_plain(*(t.to(dtype) for t in inputs),
                                             dy.to(dtype), ds.to(dtype))
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=1e-10, atol=1e-12)
    for part, g, wt in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == dtype and g.shape == wt.shape, part
        torch.testing.assert_close(g.double(), wt, **tol, msg=part)


def test_ssd_dA_summed_pair_by_pair_is_closer_to_the_f64_gradient():
    """dA through the reverse cumsum of d(seg) subtracts the row and
    column sums of the same terms; summed pair by pair with the cumsum of
    dt (as the kernel and the plain version sum it), the f32 dA is more
    than twice as close to the f64 gradient (3.7x at these inputs)."""
    bh, nc, l, p, n = 4, 2, 128, 16, 32
    rng = _rng(0)
    x = _t(rng, bh, nc, l, p)
    B, C = _t(rng, bh, nc, l, n, scale=0.3), _t(rng, bh, nc, l, n, scale=0.3)
    dt = torch.from_numpy(rng.uniform(0.0, 1.4, (bh, nc, l)))
    A = torch.from_numpy(-rng.uniform(1.0, 16.0, (bh,)))
    dy, ds = _t(rng, bh, nc, l, p), _t(rng, bh, nc, n, p)
    truth = ssd.ssd_intra_chunk_backward_plain(x, dt, A, B, C, dy, ds)[2]
    f32 = [t.float() for t in (x, dt, A, B, C, dy, ds)]
    pairwise = ssd.ssd_intra_chunk_backward_plain(*f32)[2]
    dseg = ssd._bwd_terms_plain(*f32)[4]
    g = torch.flip(torch.cumsum(torch.flip(dseg, (-1,)), -1), (-1,))
    through_seg = (f32[1] * g).sum((1, 2))

    def rel(a):
        return float((a.double() - truth).norm() / truth.norm())
    assert rel(pairwise) < rel(through_seg) / 2, (rel(pairwise),
                                                  rel(through_seg))


def test_ssd_fn_carries_the_gradient_on_the_cpu():
    inputs, dy, ds = _ssd_inputs(SSD_CASES["two_chunks"], torch.float32)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, s = ssd.SsdIntraChunkFn.apply(*leaves)
    got = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    want = _ssd_autograd(inputs, dy, ds)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), wt, **F32_TOL)


def test_ssd_fn_takes_a_gradient_of_y_alone():
    """Only y_intra used: the state's gradient arrives as None."""
    inputs, dy, _ = _ssd_inputs(SSD_CASES["short_chunk"], torch.float32)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, _ = ssd.SsdIntraChunkFn.apply(*leaves)
    got = torch.autograd.grad((y * dy).sum(), leaves)
    zero_ds = torch.zeros(inputs[0].shape[:2] + (inputs[3].shape[-1],
                                                 inputs[0].shape[-1]))
    want = _ssd_autograd(inputs, dy, zero_ds)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g.double(), wt, **F32_TOL)


def test_ssd_backward_of_bf16_inputs_is_the_f32_function_at_them():
    """bf16 x, B, C: the backward widens them exactly and computes the
    f32 gradient; each gradient comes back in its input's dtype."""
    inputs, dy, ds = _ssd_inputs(SSD_CASES["two_chunks"], torch.float32)
    x, dt, A, B, C = inputs
    lo = (x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    got = ssd.ssd_intra_chunk_backward_plain(*lo, dy, ds)
    want = ssd.ssd_intra_chunk_backward_plain(
        *(t.float() for t in lo), dy, ds)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in lo]
    grads = torch.autograd.grad(
        sum((o * g_).sum() for o, g_ in zip(ssd.SsdIntraChunkFn.apply(*leaves),
                                            (dy, ds))), leaves)
    assert [g.dtype for g in grads] == [t.dtype for t in lo]


# ------------------------------------- the bf16 tensor-core design

def _pieces(t, k):
    """t (f32) as k bf16 pieces (each a bf16 value held in f32): hi, then
    the rounding of each remainder, as ssd_scan_bwd.cu `split2` and
    `split3` cut it."""
    out, r = [], t.float()
    for _ in range(k):
        h = r.bfloat16().float()
        out.append(h)
        r = r - h
    return out


def _tc_backward_emulated(x, dt, A, B, C, dy, ds, pieces=True):
    """ssd_scan_bwd.cu's bf16 design in plain torch: seg and cs in f64,
    each exp of an f64 difference rounded to f32; every product of two
    bf16 values (exact in f32) summed in f32.  dy enters in three bf16
    pieces (dy x^T), the scores and dcb in two (dx, dB, dC; dx drops
    scores_lo dy_mid and dy_lo), ds in two.  With pieces=False every f32
    operand is rounded to bf16 once instead."""
    f32 = torch.float32
    k3, k2 = (3, 2) if pieces else (1, 1)
    x, B, C = x.to(f32), B.to(f32), C.to(f32)
    seg = torch.cumsum(dt.double() * A.double()[:, None, None], dim=2)
    cs = torch.cumsum(dt.double(), dim=2)
    l = x.shape[2]
    mask = torch.ones((l, l), dtype=torch.bool).tril()
    diff = (seg[..., :, None] - seg[..., None, :]).to(f32)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    dtf = dt[..., None, :]
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    dyp, dsp = _pieces(dy, k3), _pieces(ds, k2)
    dsc = sum(torch.einsum("bcip,bcjp->bcij", d, x) for d in dyp) * mask
    scores = cb * L * dtf
    dcb = dsc * L * dtf
    sp, dp = _pieces(scores, k2), _pieces(dcb, k2)
    e = torch.exp((seg[..., -1:] - seg).to(f32))
    w = e * dt
    bds = sum(torch.einsum("bcjn,bcnp->bcjp", B, d) for d in dsp)
    dsx = sum(torch.einsum("bcnp,bcjp->bcjn", d, x) for d in dsp)
    dw = (B * dsx).sum(-1)
    terms = [(sp[-1], dyp[0])] + ([(sp[0], dyp[1]), (sp[0], dyp[0])]
                                  if pieces else [])
    dx = sum(torch.einsum("bcij,bcip->bcjp", a, b_) for a, b_ in terms) \
        + w[..., None] * bds
    dC = sum(torch.einsum("bcij,bcjn->bcin", d, B) for d in dp)
    dB = sum(torch.einsum("bcij,bcin->bcjn", d, C) for d in dp) \
        + w[..., None] * dsx
    ddt = (dsc * cb * L).sum(-2) + dw * e
    p_ = dsc * scores
    dww = dw * w
    dseg = p_.sum(-1) - p_.sum(-2) - dww
    dseg[..., -1] += dww.sum(-1)
    dcs = (cs[..., :, None] - cs[..., None, :]).to(f32)
    dA = ((p_ * dcs).sum((-1, -2))
          + (dww * (cs[..., -1:] - cs).to(f32)).sum(-1)).sum(-1)
    return dx, ssd._seg_to_dt(dt, A, ddt, dseg), dA, dB, dC


def _tc_inputs(seed=0):
    """mamba2-130m's chunk widths (l 256, p 64, n 128), bh 2, one chunk,
    drawn as chip_smoke draws its SSD backward's inputs (bf16 x, B, C;
    A from -1 to -16)."""
    bh, nc, l, p, n = 2, 1, 256, 64, 128
    rng = _rng(seed)
    x = _t(rng, bh, nc, l, p, dtype=torch.bfloat16)
    B = _t(rng, bh, nc, l, n, scale=0.3, dtype=torch.bfloat16)
    C = _t(rng, bh, nc, l, n, scale=0.3, dtype=torch.bfloat16)
    dt = torch.from_numpy(rng.uniform(0.0, 0.1, (bh, nc, l))).float()
    A = torch.tensor([-1.0, -16.0])
    dy = _t(rng, bh, nc, l, p, dtype=torch.float32)
    ds = _t(rng, bh, nc, n, p, dtype=torch.float32)
    return x, dt, A, B, C, dy, ds


def test_ssd_tc_precision_scheme_holds_the_f64_gradient():
    """The bf16 design's operand pieces, emulated in plain torch, hold
    dx, ddt, dA, dB and dC within BWD_TOLERANCE of the f64 gradient (at
    0.12 of it at this seed, the f32 plain version at 0.07); bf16
    operands rounded once miss it 200-fold."""
    args = _tc_inputs()
    truth = ssd.ssd_intra_chunk_backward_plain(*(a.double() for a in args))
    got = _tc_backward_emulated(*args)
    for part, g, t_ in zip(("dx", "ddt", "dA", "dB", "dC"), got, truth):
        assert g.dtype == torch.float32 and g.shape == t_.shape, part
        err, ratio = worst_ratio(g, t_, *ssd.BWD_TOLERANCE)
        assert ratio <= 0.5, (part, err, ratio)
    once = _tc_backward_emulated(*args, pieces=False)
    assert worst_ratio(once, truth, *ssd.BWD_TOLERANCE)[1] > 10


def test_ssd_bwd_routes_widths_and_splits():
    bf16, f32 = torch.bfloat16, torch.float32
    assert ssd.route(bf16) == ssd.TENSOR_CORES
    assert ssd.route(f32) == ssd.CUDA_CORES
    widths = {v: ssd.bwd_width(v) for v in range(8, ssd.MAX_DIM + 1, 8)}
    assert widths[8] == widths[16] == 16 and widths[24] == widths[32] == 32
    assert {widths[v] for v in (40, 48, 56, 64)} == {64}
    assert {widths[v] for v in range(72, 129, 8)} == {128}
    # the column pass splits in two only where both widths are 128
    assert [ssd.bwd_col_splits(bf16, p, n) for p, n in (
        (64, 128), (128, 64), (72, 72), (128, 128), (64, 64))] == [
        1, 1, 2, 2, 1]
    assert ssd.bwd_col_splits(f32, 128, 128) == 1
    # one block per (batch*head, chunk, 64-row slab) in each launch
    assert ssd.bwd_num_blocks(96, 8, 256) == 3072
    assert ssd.bwd_num_blocks(160, 8, 256) == 5120
    assert ssd.bwd_num_blocks(3, 2, 200) == 24
    assert ssd.bwd_num_blocks(2, 1, 5) == 2


def test_ssd_bwd_geometry_mirrors_the_kernel_source():
    """ops.py's constants and shared-memory mirror against
    csrc/ssd_scan_bwd.cu: the tc namespace's constants, the widths, the
    bytes its header states, and every width pair within a block."""
    import re
    from pathlib import Path
    src = (Path(ssd.__file__).parents[1] / "csrc" / "ssd_scan_bwd.cu").read_text()
    tc = src[src.index("namespace tc {"):]
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", tc)}
    assert const["kThreads"] == 128
    assert const["kSlab"] == ssd.BWD_SLAB
    assert const["kTok"] == ssd.BWD_TC_TILE
    assert const["kPad"] == ssd.TC_PAD
    assert const["kMaxChunk"] == ssd.MAX_CHUNK
    assert "v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128" in tc
    assert "return pw + nw > 192 ? 2 : 1;" in tc
    bf16, f32 = torch.bfloat16, torch.float32
    assert ssd.bwd_smem_bytes(bf16, 64, 128) == (80_448, 74_816)
    assert ssd.bwd_smem_bytes(bf16, 64, 64) == (64_064, 58_432)
    assert ssd.bwd_smem_bytes(bf16, 40, 104) == ssd.bwd_smem_bytes(bf16, 64,
                                                                   128)
    for v in ("80,448", "74,816", "64,064", "58,432", "110,592", "138,880"):
        assert v in src, v
    # the f32 design's (k_smem_floats, q_smem_floats) is unchanged
    assert ssd.bwd_smem_bytes(f32, 128, 128) == (138_880, 110_592)
    for p in range(8, ssd.MAX_DIM + 1, 8):
        for n in range(8, ssd.MAX_DIM + 1, 8):
            for dtype in (bf16, f32):
                assert max(ssd.bwd_smem_bytes(dtype, p, n)) <= ssd.MAX_SMEM


# ----------------------------------------------------------- refusals

@pytest.mark.parametrize("which", ["grouped_matmul", "ssd_intra_chunk"])
def test_forward_only_launchers_refuse_grad_enabled_inputs(which):
    if which == "grouped_matmul":
        x, w, _, rows = _gm_inputs(GM_CASES["partly_live"], torch.float32)
        args, call, fn = (x, w, rows), gm.grouped_matmul, "GroupedMatmulFn"
    else:
        inputs, _, _ = _ssd_inputs(SSD_CASES["two_chunks"], torch.float32)
        args, call, fn = inputs, ssd.ssd_intra_chunk, "SsdIntraChunkFn"
    want = call(*args)                                   # nothing needs grad
    grad_args = [a.clone().requires_grad_() if torch.is_tensor(a)
                 and a.is_floating_point() else a for a in args]
    with pytest.raises(RuntimeError, match=fn):
        call(*grad_args)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            got = call(*grad_args)
        for g, wt in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, wt, rtol=0, atol=0)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hold(got, want, rtol, atol, floor=None):
    for g, w in zip(got, want):
        err, ratio = worst_ratio(g, w, rtol, atol, floor=floor)
        assert ratio <= 1.0, (err, ratio)


# (E, C, K, F): qwen3-moe-30b-a3b's gate/up and down products at its
# training capacity, and ragged small shapes
GM_CARD_CASES = [(128, 320, 2048, 768), (128, 320, 768, 2048),
                 (4, 40, 64, 32), (3, 100, 72, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", GM_CARD_CASES)
def test_grouped_backward_kernel_matches_plain_on_card(cuda_device, case,
                                                       dtype):
    E, C, K, F = case
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rows = torch.randint(0, C + 30, (E,), generator=g,
                         device=cuda_device).to(torch.int32)
    rows[0] = 0
    x = torch.randn(E, C, K, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(E, K, F, generator=g, device=cuda_device) * 0.05).to(dtype)
    dy = torch.randn(E, C, F, generator=g, device=cuda_device)
    got = gm.grouped_matmul_backward(x, w, dy, rows)
    want = gm.grouped_matmul_backward_plain(x, w, dy, rows)
    torch.cuda.synchronize()
    assert all(t.dtype == dtype for t in got)
    # bf16 stores the f32 sums rounded once: TOLERANCE plus that rounding
    _hold(got, want, *gm.TOLERANCE[dtype],
          floor=gm.bf16_rounding if dtype == torch.bfloat16 else None)
    again = gm.grouped_matmul_backward(x, w, dy, rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _gm_card_inputs(dev, E, C, K, F, live, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = None if live is None else torch.tensor(live, dtype=torch.int32,
                                                  device=dev)
    x = torch.randn(E, C, K, generator=g, device=dev).bfloat16()
    w = (torch.randn(E, K, F, generator=g, device=dev) * 0.05).bfloat16()
    dy = torch.randn(E, C, F, generator=g, device=dev)
    return x, w, dy, rows


# (E, C, K, F, live): each live count the 64-row granules and the
# 128-row items meet, at K and F multiples of 8 but not of 64 (K 264:
# two 256-column dX tiles, the second 8 wide), and every row live
GM_RAGGED_CARD_CASES = [
    (9, 200, 72, 40, (0, 1, 63, 64, 65, 127, 128, 129, 200)),
    (9, 200, 264, 296, (0, 1, 63, 64, 65, 127, 128, 129, 200)),
    (2, 130, 136, 24, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GM_RAGGED_CARD_CASES)
def test_grouped_backward_ragged_live_counts_on_card(cuda_device, case):
    """bf16 at ragged live counts and widths: held to the plain version
    (TOLERANCE plus the one rounding), dX zeros past the live count, a
    bit-identical rerun, each pass launched alone giving the same bits,
    and one count a call in `BACKWARD.launches`."""
    E, C, K, F, live = case
    x, w, dy, rows = _gm_card_inputs(cuda_device, E, C, K, F, live)
    before = gm.BACKWARD.launches
    got = gm.grouped_matmul_backward(x, w, dy, rows)
    assert gm.BACKWARD.launches == before + 1
    want = gm.grouped_matmul_backward_plain(x, w, dy, rows)
    torch.cuda.synchronize()
    _hold(got, want, *gm.TOLERANCE[torch.bfloat16], floor=gm.bf16_rounding)
    if rows is not None:
        dead = torch.arange(C, device=cuda_device)[None, :] >= rows[:, None]
        assert not got[0][dead].float().any()
    again = gm.grouped_matmul_backward(x, w, dy, rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    passes = gm.backward_pass_timer(x, w, dy, rows)
    assert list(passes) == ["round", "dx", "dw"]
    for fn in passes.values():
        alone = fn()
    assert all(torch.equal(a, b) for a, b in zip(got, alone))


@pytest.mark.cuda
def test_grouped_backward_never_reads_rows_past_live_on_card(cuda_device):
    """NaN written into x and dY past each expert's live rows leaves dX's
    live rows and all of dW bit-identical to a clean run (dX past the
    live rows stays zero)."""
    E, C, K, F = 9, 200, 264, 296
    live = (0, 1, 63, 64, 65, 127, 128, 129, 200)
    x, w, dy, rows = _gm_card_inputs(cuda_device, E, C, K, F, live, seed=4)
    clean = gm.grouped_matmul_backward(x, w, dy, rows)
    dead = torch.arange(C, device=cuda_device)[None, :] >= rows[:, None]
    x[dead] = float("nan")
    dy[dead] = float("nan")
    dirty = gm.grouped_matmul_backward(x, w, dy, rows)
    torch.cuda.synchronize()
    assert torch.equal(clean[0], dirty[0]) and not dirty[0][dead].float().any()
    assert torch.equal(clean[1], dirty[1])


@pytest.mark.cuda
def test_grouped_bwd_occupancy_matches_the_mirror(cuda_device):
    for kind in ("dx", "dw"):
        assert gm.launched_bwd_blocks_per_sm(kind) == gm.bwd_blocks_per_sm()


# (bh, nc, l, p, n): mamba2-130m's training chunks (p 64, n 128), a
# ragged chunk, zamba2's (p = n = 64), a tiny one, and widths that take
# the bf16 column pass's split (p = n = 128) and pad p and n to 64 and
# 128 (40, 104)
SSD_CARD_CASES = [(24, 2, 256, 64, 128), (3, 2, 200, 64, 128),
                  (40, 2, 256, 64, 64), (2, 1, 5, 8, 16),
                  (4, 2, 130, 128, 128), (3, 1, 70, 40, 104)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SSD_CARD_CASES)
def test_ssd_backward_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """Each route against the plain version and against the f64 plain
    version (the exact gradient at the inputs), and a bit-identical
    rerun."""
    bh, nc, l, p, n = case
    g = torch.Generator(device=cuda_device).manual_seed(2)
    dev = cuda_device
    x = torch.randn(bh, nc, l, p, generator=g, device=dev).to(dtype)
    B = (torch.randn(bh, nc, l, n, generator=g, device=dev) * 0.3).to(dtype)
    C = (torch.randn(bh, nc, l, n, generator=g, device=dev) * 0.3).to(dtype)
    dt = torch.rand(bh, nc, l, generator=g, device=dev) * 0.1
    A = -torch.rand(bh, generator=g, device=dev) * 4 - 0.5
    dy = torch.randn(bh, nc, l, p, generator=g, device=dev)
    ds = torch.randn(bh, nc, n, p, generator=g, device=dev)
    args = (x, dt, A, B, C, dy, ds)
    got = ssd.ssd_intra_chunk_backward(*args)
    want = ssd.ssd_intra_chunk_backward_plain(*args)
    torch.cuda.synchronize()
    _hold(got, want, *ssd.BWD_TOLERANCE)
    truth = ssd.ssd_intra_chunk_backward_plain(*(a.double() for a in args))
    _hold(got, truth, *ssd.BWD_TOLERANCE)
    again = ssd.ssd_intra_chunk_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_fns_carry_the_gradient_through_the_kernels_on_card(cuda_device):
    x, w, dy, rows = _gm_inputs(GM_CASES["partly_live"], torch.float32)
    xa, wa = (t.to(cuda_device).requires_grad_() for t in (x, w))
    before = gm.BACKWARD.launches
    out = gm.GroupedMatmulFn.apply(xa, wa, rows.to(cuda_device))
    got = torch.autograd.grad(out, (xa, wa), dy.to(cuda_device))
    assert gm.BACKWARD.launches == before + 1
    want = gm.grouped_matmul_backward_plain(x, w, dy, rows)
    _hold([t.cpu() for t in got], want, *gm.TOLERANCE[torch.float32])
    inputs, sdy, sds = _ssd_inputs(SSD_CASES["two_chunks"], torch.float32)
    leaves = [t.to(cuda_device).requires_grad_() for t in inputs]
    before = ssd.BACKWARD.launches
    y, s = ssd.SsdIntraChunkFn.apply(*leaves)
    got = torch.autograd.grad((y * sdy.to(cuda_device)).sum()
                              + (s * sds.to(cuda_device)).sum(), leaves)
    assert ssd.BACKWARD.launches == before + 1
    want = ssd.ssd_intra_chunk_backward_plain(*inputs, sdy, sds)
    _hold([t.cpu() for t in got], want, *ssd.BWD_TOLERANCE)
