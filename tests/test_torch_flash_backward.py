"""The flash-attention backward of the port: the plain version against
autograd, `FlashAttentionFn` under gradcheck, the forward-only launcher's
refusal of grad-enabled inputs, and (marked `cuda`, skipped without a
card) the backward kernel against its plain version.

This file imports neither JAX nor the reference, so it also runs where
only PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_backward.py
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fk
from repro_torch.kernels.tolerance import TOLERANCE, grad_floor, worst_ratio
from repro_torch.models import layers as PL
from repro_torch.models.config import ModelConfig

# (b, sq, skv, hq, hkv, d, causal, q_offset)
CASES = {
    "causal": (2, 9, 9, 4, 2, 16, True, 0),
    "full": (1, 7, 11, 4, 4, 8, False, 0),
    "gqa4_offset": (1, 6, 13, 8, 2, 16, True, 7),
    "mqa": (2, 5, 5, 4, 1, 8, True, 0),
}


def _inputs(case, dtype=torch.float32, seed=0):
    b, sq, skv, hq, hkv, d, causal, off = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return (t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d),
            t(b, sq, hq, d), dict(causal=causal, q_offset=off))


def _autograd(q, k, v, do, kw):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o = fk.flash_attention_plain(q, k, v, **kw)
    return torch.autograd.grad(o, (q, k, v), do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_plain_equals_autograd_over_the_plain_forward(name, dtype):
    q, k, v, do, kw = _inputs(CASES[name], dtype)
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    got = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    want = _autograd(q, k, v, do, kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_a_row_that_sees_no_key_gets_zero_gradient_not_nan():
    """Causal queries placed before key 0 (q_offset -3): rows 0-2 see no
    key, their lse is -inf, and the backward gives them zeros."""
    q, k, v, do, _ = _inputs((1, 6, 8, 4, 2, 8, True, 0))
    kw = dict(causal=True, q_offset=-3)
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    assert torch.isneginf(lse[:, :, :3]).all()
    assert torch.isfinite(lse[:, :, 3:]).all()
    dq, dk, dv = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert (dq[:, :3] == 0).all() and (dq[:, 3:] != 0).any()
    for g, w in zip((dq, dk, dv), _autograd(q, k, v, do, kw)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_a_minus_inf_lse_row_contributes_nothing():
    """The kernel's guard, as its plain version states it: a row handed
    lse -inf is treated as seeing no key, whatever its scores."""
    q, k, v, do, kw = _inputs(CASES["causal"])
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    lse = lse.clone()
    lse[0, 1, 4] = -float("inf")
    dq, dk, dv = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    assert (dq[0, 4, 1] == 0).all()
    # the same gradients as with that row's dO zeroed (row 4 of head 1)
    do0 = do.clone()
    do0[0, 4, 1] = 0
    ref = fk.flash_attention_backward_plain(
        q, k, v, o, do0, fk.flash_attention_lse_plain(q, k, v, **kw)[1],
        **kw)
    for g, w in zip((dk, dv), ref[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 2), (False, 0)])
def test_flash_attention_fn_passes_gradcheck_on_its_plain_path(causal, off):
    q, k, v, _, _ = _inputs((1, 4, 6, 4, 2, 4, causal, off), torch.float64)
    args = [x.requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: fk.FlashAttentionFn.apply(a, b, c, causal, off),
        args, eps=1e-6, atol=1e-7)


def test_bf16_plain_backward_tracks_the_f32_gradient():
    """In bf16 the plain version rounds P and dS as the kernel does; it
    stays near the f32 gradient (relative L2 error of each output)."""
    case = (1, 40, 40, 4, 2, 32, True, 0)
    q, k, v, do, kw = _inputs(case)
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    want = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    ob, lseb = fk.flash_attention_lse_plain(qb, kb, vb, **kw)
    got = fk.flash_attention_backward_plain(qb, kb, vb, ob, dob, lseb, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        rel = ((g.float() - w).norm() / w.norm()).item()
        assert rel < 2e-2, rel


# ------------------------------------------------- the repair of section 0

def _cfg(impl):
    return ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                       vocab_size=16, num_heads=4, num_kv_heads=2,
                       head_dim=8, d_ff=64, attention_impl=impl,
                       attn_chunk=8, max_seq=32)


def test_forward_only_launcher_refuses_grad_enabled_inputs():
    q, k, v, _, kw = _inputs(CASES["causal"])
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        fk.flash_attention(q, k, v, **kw)
    with torch.no_grad():            # serving: no grad, no refusal
        o = fk.flash_attention(q, k, v, **kw)
    assert o.grad_fn is None
    with torch.inference_mode():
        fk.flash_attention(q, k, v, **kw)


def test_run_attention_on_the_kernel_route_carries_the_gradient():
    """`flash_pallas` on the CPU is the kernel route's plain twin: with
    grad enabled it goes through FlashAttentionFn and its gradients equal
    autograd over the plain forward; without grad it takes the
    forward-only launcher."""
    cfg = _cfg("flash_pallas")
    q, k, v, do, _ = _inputs((2, 9, 9, 4, 2, 8, True, 0))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = PL.run_attention(cfg, *leaves)
    assert "FlashAttentionFn" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, do)
    want = _autograd(q, k, v, do, dict(causal=True, q_offset=0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert PL.run_attention(cfg, *leaves).grad_fn is None


@pytest.mark.parametrize("impl", ["dense", "flash_xla"])
def test_run_attention_cpu_paths_stay_plain_under_grad(impl):
    """On the CPU `dense` and `flash_xla` stay the reference's paths
    (autograd through plain torch), grads equal the kernel route's."""
    q, k, v, do, _ = _inputs((1, 12, 12, 4, 2, 8, True, 0))
    grads = {}
    for name in (impl, "flash_pallas"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = PL.run_attention(_cfg(name), *leaves)
        grads[name] = torch.autograd.grad(o, leaves, do)
    assert "FlashAttentionFn" not in type(
        PL.run_attention(_cfg(impl), q.requires_grad_(), k, v).grad_fn
    ).__name__
    for g, w in zip(grads[impl], grads["flash_pallas"]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,match", [(272, "up to 256"),
                                     (144, "bf16 backward takes")])
def test_backward_launcher_refuses_head_dims_it_has_no_layout_for(d, match):
    """The launcher's checks run before any build: past 256, and a bf16
    head dim past 128 that two column halves of a multiple of 16 do not
    make (f32 takes 144)."""
    q, k, v, do, kw = (x.bfloat16() if torch.is_tensor(x) else x
                       for x in _inputs((1, 8, 8, 2, 2, d, True, 0)))
    o, lse = (x.contiguous() for x in fk.flash_attention_lse_plain(
        q, k, v, **kw))
    with pytest.raises(ValueError, match=match):
        fk._launch_bwd(q, k, v, o, do, lse, True, 0)
    assert [fk.bwd_col_splits(x) for x in (16, 128, 160, 192, 256)] == [
        1, 1, 2, 2, 2]
    assert fk.BWD_TC_HEAD_DIMS[-5:] == (128, 160, 192, 224, 256)


def test_bwd_shared_memory_mirror_fits_a_block():
    for dtype in (torch.bfloat16, torch.float32):
        for d in range(16, fk.MAX_BWD_HEAD_DIM + 1, 16):
            assert max(fk.bwd_smem_bytes(dtype, d)) <= fk.MAX_SMEM


_BWD_SRC = (Path(fk.__file__).resolve().parents[1] / "csrc"
            / "flash_attention_bwd.cu").read_text()


def _wg_constant(name):
    """`constexpr int name = value;` in the wgmma design's namespace."""
    wg = _BWD_SRC[_BWD_SRC.index("namespace wg {"):
                  _BWD_SRC.index("}  // namespace wg")]
    m = re.search(rf"\b{name} = (\d+)", wg)
    assert m, name
    return int(m[1])


def test_bwd_wg_mirrors_match_the_source():
    """ops.py's mirrors of the wgmma design against the .cu constants:
    the geometry, threads, setmaxnreg's budget, the head dims `wg::takes`
    states, the panels, ring depth and roles by width, the pass bits, and
    each head dim's shared memory by the source's own formulas
    (`wg::dkdv_smem_bytes`, `wg::dq_smem_bytes`)."""
    consumers = _wg_constant("kConsumers")
    keys, rows = 64 * consumers, 64 * consumers
    q_rows, tok = _wg_constant("kQ"), _wg_constant("kTok")
    assert (fk.BWD_WG_KEYS, fk.BWD_WG_QROWS, fk.BWD_WG_ROWS,
            fk.BWD_WG_TOKENS) == (keys, q_rows, rows, tok)
    assert "padded(int d) { return (d + 63) / 64 * 64; }" in _BWD_SRC
    assert "wide(int d) { return padded(d) > 128; }" in _BWD_SRC
    assert "stages(int d) { return wide(d) ? 2 : 3; }" in _BWD_SRC
    assert re.search(r"dim3\(b \* hkv, \(skv \+ kKeys - 1\) / kKeys \* splits, "
                     r"wide\(D\) \? 2 : 1\)", _BWD_SRC)
    threads = 128 * (consumers + 1)
    assert fk.BWD_WG_THREADS == threads
    # ptxas gives each thread 65536 / threads registers at entry; the
    # producers' and consumers' setmaxnreg counts must fit in that
    entry = 65536 // threads // 8 * 8
    assert (128 * _wg_constant("kProducerRegs")
            + 128 * consumers * _wg_constant("kConsumerRegs")
            <= threads * entry)
    assert re.search(r"takes\(int d\) \{ return d % 16 == 0 && d >= 64 "
                     r"&& d <= 192; \}", _BWD_SRC)
    assert fk.BWD_WG_HEAD_DIMS == tuple(
        d for d in fk.BWD_TC_HEAD_DIMS if 64 <= d <= 192)
    passes = dict(re.findall(r"kPass(\w+) = (\d+)", _BWD_SRC))
    assert {k.lower(): int(v) for k, v in passes.items()} == {
        k.lower(): v for k, v in fk.BWD_PASSES.items()}
    assert fk.BWD_ALL_PASSES == 15
    for d in fk.BWD_WG_HEAD_DIMS:
        dp = -(-d // 64) * 64
        stages = 3 if dp <= 128 else 2
        assert (fk.bwd_wg_padded(d), fk.bwd_wg_stages(d),
                fk.bwd_wg_roles(d)) == (dp, stages, 1 if dp <= 128 else 2)
        want = (1024 + 2 * (2 * keys + stages * 2 * q_rows) * dp
                + stages * q_rows * 12 + stages * 16,
                1024 + 2 * (2 * rows + stages * 2 * tok) * dp + stages * 16)
        assert fk.bwd_wg_smem_bytes(d) == want
        assert fk.bwd_smem_bytes(torch.bfloat16, d) == want
        assert max(want) <= fk.MAX_SMEM


def test_every_bf16_head_dim_has_a_design():
    """Each head dim the bf16 backward takes has exactly one design, chosen
    by d alone: wgmma from 64 to 192, mma.sync below and past it."""
    designs = {d: fk.bwd_design(d) for d in fk.BWD_TC_HEAD_DIMS}
    assert {d for d, x in designs.items() if x == fk.WGMMA} == set(
        fk.BWD_WG_HEAD_DIMS)
    assert {d for d, x in designs.items() if x == fk.MMA_SYNC} == {
        16, 32, 48, 224, 256}
    assert set(fk.BWD_WG_HEAD_DIMS) <= set(fk.BWD_TC_HEAD_DIMS)


@pytest.mark.parametrize("shape,d,splits", [
    ((4, 2048, 2048, 8, 2), 128, 1),     # internlm2's training microbatch
    ((1, 2048, 2048, 4, 8), 128, 5),     # qwen3-moe-30b-a3b's group of 8
    ((1, 511, 511, 8, 2), 128, 4),       # ragged 511: capped by the walk
    ((1, 64, 64, 1, 1), 128, 1),         # one step: nothing to split
    ((1, 2048, 2048, 1, 64), 128, 16),   # capped at MAX_GROUP_SPLITS
    ((2, 2048, 2048, 32, 1), 160, 1),    # zamba2's: 2 roles a tile
    ((1, 2048, 2048, 8, 12), 192, 2),    # nemotron's group of 12
])
def test_bwd_group_splits_rule_and_grids(shape, d, splits):
    b, sq, skv, hkv, group = shape
    got = fk.bwd_group_splits(b, sq, skv, hkv, group, sms=132, d=d)
    assert got == splits
    tiles = -(-skv // fk.BWD_WG_KEYS)
    blocks = fk.bwd_blocks(b, sq, skv, hkv * group, hkv, d, got)
    assert blocks == {"dkdv": b * hkv * tiles * got * fk.bwd_wg_roles(d),
                      "dq": b * hkv * -(-sq * group // fk.BWD_WG_ROWS)}
    assert tiles * got <= fk.MAX_GRID_Y
    # every chunk's share: the whole walk, in order, no step twice
    for n in (1, 7, 64, 256):
        steps = [j for c in range(got)
                 for j in range(*fk.bwd_chunk(n, got, c))]
        assert steps == list(range(n))


def test_group_split_emulation_sums_to_the_plain_gradient():
    """The kernel's split, emulated in f32: each 128-key tile's walk of
    packed rows (query position, group member) from its causal start, cut
    into `splits` chunks of whole 64-row steps (`bwd_chunk`), each
    chunk's partial dK and dV summed in chunk order, equals
    `flash_attention_backward_plain` within f32 rounding (a GQA group of
    8, three key tiles, the last ragged)."""
    b, s_, hq, hkv, d, off = 1, 300, 16, 2, 16, 0
    q, k, v, do, kw = _inputs((b, s_, s_, hq, hkv, d, True, off), seed=11)
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    _, dk, dv = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    g, scale = hq // hkv, 1.0 / d ** 0.5
    qg, dog = (x.reshape(b, s_, hkv, g, d) for x in (q, do))
    p = torch.exp(torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
                  - lse.reshape(b, hkv, g, s_, 1))
    p = torch.where(fk._mask(s_, s_, off, q.device), p, 0.0)
    dsum = (do * o).sum(-1).reshape(b, s_, hkv, g).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, v) - dsum[..., None])
    # packed row r = qi * g + gi of each kv head, as (b, hkv, g, sq) masks
    packed = (torch.arange(s_)[None, :] * g
              + torch.arange(g)[:, None])[None, None]
    splits = fk.bwd_group_splits(b, s_, s_, hkv, g, sms=132)
    assert splits > 1
    rows, step = s_ * g, fk.BWD_WG_QROWS
    got_k, got_v = torch.zeros_like(dk), torch.zeros_like(dv)
    for t0 in range(0, s_, fk.BWD_WG_KEYS):
        keys = slice(t0, min(s_, t0 + fk.BWD_WG_KEYS))
        r_begin = min(rows, max(0, t0 - off) * g)
        n_q = -(-(rows - r_begin) // step)
        acc_k = acc_v = 0.0
        for c in range(splits):
            j0, j1 = fk.bwd_chunk(n_q, splits, c)
            live = ((packed >= r_begin + j0 * step)
                    & (packed < r_begin + j1 * step))[..., None]
            pc, dsc = p[..., keys] * live, ds[..., keys] * live
            acc_v = acc_v + torch.einsum("bhgqk,bqhgd->bkhd", pc, dog)
            acc_k = acc_k + torch.einsum("bhgqk,bqhgd->bkhd", dsc,
                                         qg) * scale
        got_k[:, keys], got_v[:, keys] = acc_k, acc_v
    torch.testing.assert_close(got_k, dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_v, dv, rtol=1e-5, atol=1e-6)


def _key_tile_dq(q, k, v, o, do, lse, lo, hi):
    """Keys lo:hi's share of dQ (causal, one head per kv head, f32), as
    the plain version forms it."""
    scale = 1.0 / q.shape[-1] ** 0.5
    kt, vt = k[:, lo:hi], v[:, lo:hi]
    live = torch.arange(q.shape[1])[:, None] >= torch.arange(lo, hi)[None]
    p = torch.where(live, torch.exp(
        torch.einsum("bqhd,bkhd->bhqk", q, kt) * scale - lse[..., None]), 0.0)
    dsum = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vt) - dsum)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kt) * scale


@pytest.mark.parametrize("drop", ["query_step", "key_tile"])
def test_backward_check_refuses_a_dropped_query_step_or_key_tile(drop):
    """The card's check of the backward (the bf16 rule, per row with the
    floor `grad_floor`) at 1,024 causal tokens refuses the gradients of a
    kernel that skipped one step of its loop: dK and dV less one 32-row
    query step's share, or dQ less one 64-key tile's share, late in the
    sequence where the rows are smallest."""
    q, k, v, do, kw = _inputs((1, 1024, 1024, 2, 2, 64, True, 0), seed=7)
    o, lse = fk.flash_attention_lse_plain(q, k, v, **kw)
    dq, dk, dv = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    if drop == "query_step":
        do_drop = do.clone()
        do_drop[:, 960:992] = 0          # their dS is 0: no share in dK, dV
        got = fk.flash_attention_backward_plain(q, k, v, o, do_drop, lse,
                                                **kw)[1:]
        want = (dk, dv)
    else:
        got = (dq - _key_tile_dq(q, k, v, o, do, lse, 896, 960),)
        want = (dq,)
    rtol, atol = TOLERANCE[torch.bfloat16]
    assert worst_ratio(got, want, rtol, atol, floor=grad_floor)[1] > 1


def test_flash_bwd_mutants_still_plant_their_faults():
    """Each mutant of `benchmarks/flash_bwd_mutants.py` (run on the card)
    still finds its lines in the backward's source, and plants a fault in
    each bf16 design it names: the wgmma design's `namespace wg` and the
    mma.sync design's `namespace tc`."""
    from repro_torch.benchmarks import flash_bwd_mutants as fm
    src = (fm.ROOT / "src" / fm.BWD).read_text()

    def section(text, ns):
        return text[text.index(f"namespace {ns} {{"):
                    text.index(f"}}  // namespace {ns}")]
    assert set(fm.DESIGNS) == set(fm.MUTANTS) - {"kernel"}
    for name in fm.MUTANTS:
        got = fm.mutate(src, name)
        assert (got == src) == (name == "kernel")
        for design, ns in ((fk.WGMMA, "wg"), (fk.MMA_SYNC, "tc")):
            planted = section(got, ns) != section(src, ns)
            assert planted == (design in fm.DESIGNS.get(name, ())), (
                name, design)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check(got, want, dtype, floor=None):
    rtol, atol = TOLERANCE[dtype]
    for g, w in zip(got, want):
        err, ratio = worst_ratio(g, w, rtol, atol, floor=floor)
        assert ratio <= 1.0, (err, ratio)


def _check_grads(got, want, dtype):
    """dQ, dK and dV, per row with the floor `tolerance.grad_floor`."""
    _check(got, want, dtype, floor=grad_floor)


# (b, sq, skv, hq, hkv, d, causal, q_offset): internlm2's heads, qwen3's
# group, ragged lengths, a q_offset, non-causal, small head dims (16: the
# mma.sync design), the wgmma design's padded head dims (96, 80), past
# 128 on it (a dV and a dK block a key tile): zamba2's shared attention
# (d 160, no GQA) and a group of 12 at nemotron's d 192, ragged, offset
# and non-causal; and d 256 (mma.sync, two column halves a block row)
CARD_CASES = [
    (1, 200, 200, 8, 2, 96, True, 0),
    (1, 130, 150, 4, 4, 80, False, 0),
    (2, 130, 130, 4, 4, 160, True, 0),
    (1, 100, 300, 12, 1, 192, True, 200),
    (1, 70, 97, 4, 2, 192, False, 0),
    (1, 64, 64, 2, 2, 256, True, 0),
    (2, 256, 256, 16, 8, 128, True, 0),
    (1, 511, 511, 16, 8, 128, True, 0),
    (1, 100, 300, 16, 8, 128, True, 200),
    (2, 70, 130, 16, 8, 128, False, 0),
    (1, 200, 200, 32, 4, 128, True, 0),
    (1, 65, 65, 4, 4, 64, True, 0),
    (1, 33, 47, 8, 2, 16, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_backward_kernel_matches_plain_on_card(cuda_device, case, dtype):
    q, k, v, do, kw = (x.to(cuda_device).to(dtype) if torch.is_tensor(x)
                       else x for x in _inputs(case, seed=3))
    o, lse = fk.flash_attention_lse(q, k, v, **kw)
    po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _check((o,), (po,), dtype)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    n = fk.BACKWARD.launches
    got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    assert fk.BACKWARD.launches == n + 1
    want = fk.flash_attention_backward_plain(q, k, v, po, do, plse, **kw)
    torch.cuda.synchronize()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
    _check_grads(got, want, dtype)
    again = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    for a, b in zip(got, again):      # no atomics: the same bits
        assert torch.equal(a, b)


# (b, sq, skv, hq, hkv, d, causal, q_offset) where the wgmma design splits
# the group: qwen3-moe-30b-a3b's group of 8 at 2048 tokens, and d 64
SPLIT_CASES = [
    (1, 2048, 2048, 32, 4, 128, True, 0),
    (1, 300, 300, 16, 2, 64, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_group_split_matches_plain_on_card(cuda_device, case):
    """The split's partials and reduce: held to the plain version, a rerun
    bit-identical, and the same bits when each pass is launched alone."""
    q, k, v, do, kw = (x.to(cuda_device).bfloat16() if torch.is_tensor(x)
                       else x for x in _inputs(case, seed=6))
    assert fk.bwd_design(case[5]) == fk.WGMMA
    assert fk._bwd_splits(q, k) > 1
    o, lse = fk.flash_attention_lse(q, k, v, **kw)
    got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    _check_grads(got, want, torch.bfloat16)
    again = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    passes, splits = fk.backward_pass_timer(q, k, v, o, do, lse, **kw)
    assert splits > 1 and set(passes) == set(fk.BWD_PASSES)
    for name in ("D", "dkdv", "reduce", "dq"):
        alone = passes[name]()
    for a, b, c in zip(got, again, alone):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_with_lse_gives_the_serving_forward_bits(cuda_device, dtype):
    q, k, v, _, kw = (x.to(cuda_device).to(dtype) if torch.is_tensor(x)
                      else x for x in _inputs(CARD_CASES[2], seed=4))
    o, _ = fk.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, fk.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_minus_inf_lse_rows_get_zero_gradient_on_card(cuda_device, dtype):
    q, k, v, do, kw = (x.to(cuda_device).to(dtype) if torch.is_tensor(x)
                       else x for x in _inputs(CARD_CASES[5], seed=5))
    o, lse = fk.flash_attention_lse(q, k, v, **kw)
    lse[:, :, 3] = -float("inf")
    got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = fk.flash_attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in got)
    assert (got[0][:, 3] == 0).all()
    _check_grads(got, want, dtype)


@pytest.mark.cuda
def test_run_attention_on_card_never_drops_the_gradient(cuda_device):
    cfg = _cfg("flash_xla")
    q, k, v, do, kw = (x.to(cuda_device).bfloat16() if torch.is_tensor(x)
                       else x for x in _inputs((2, 64, 64, 4, 2, 16, True, 0)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    f, b = fk.launches, fk.BACKWARD.launches
    o = PL.run_attention(cfg, *leaves)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    assert (fk.launches, fk.BACKWARD.launches) == (f + 1, b + 1)
    po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
    _check_grads(got, fk.flash_attention_backward_plain(q, k, v, po, do, plse,
                                                        **kw), torch.bfloat16)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        fk.flash_attention(*leaves, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d,match", [(272, "up to 256"),
                                     (144, "bf16 backward takes")])
def test_backward_refuses_head_dims_it_has_no_layout_for(cuda_device, d,
                                                         match):
    """The first head dim past the limit, and a bf16 one past 128 that
    does not split in two halves of a multiple of 16."""
    q, k, v, do, kw = (x.to(cuda_device).bfloat16() if torch.is_tensor(x)
                       else x for x in _inputs((1, 8, 8, 2, 2, d, True, 0)))
    o, lse = (x.contiguous() for x in fk.flash_attention_lse_plain(
        q, k, v, **kw))
    with pytest.raises(ValueError, match=match):
        fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
