"""PyTorch port vs the JAX reference: paged decode / chunk-prefill
attention and the quantized-page contract.

The plain PyTorch versions (what the wrappers run on CPU tensors) are
held against the reference oracles `paged_decode_attention_ref` and
`paged_prefill_attention_ref` over a geometry matrix (the CUDA kernels
are held against the plain versions in `test_torch_kernels.py`).  f32
on the CPU: atol = rtol = 1e-5."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.unimem import dequantize_kv as jax_dequantize
from repro.core.unimem import quantize_kv as jax_quantize
from repro.kernels.paged_attention.ref import (
    paged_decode_attention_ref, paged_decode_attention_split_ref)
from repro.kernels.paged_prefill.ref import paged_prefill_attention_ref
from repro_torch.core.unimem import dequantize_kv, quantize_kv
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
from repro_torch.kernels.tolerance import TOLERANCE, worst_ratio

from torch_port_helpers import one_torch_thread  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-5)
QUANT = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}

# (group, head_dim, page): every pair of the three axes' values appears
GEOMETRY = [(1, 16, 4), (1, 32, 8), (1, 128, 16), (2, 16, 8), (2, 32, 16),
            (2, 128, 4), (4, 16, 16), (4, 32, 4), (4, 128, 8)]


class Case:
    """One arena + block tables, as numpy, for both frameworks.  Rows
    have ragged lengths (one at position 0), tables end in null-page
    tails, and the arena's pages are in shuffled order."""

    def __init__(self, seed, group, d, page, b=4, hkv=2, mp=6, quant=None):
        rng = np.random.default_rng(seed)
        self.hq, self.hkv, self.d, self.page, self.mp = group * hkv, hkv, d, page, mp
        P = b * mp
        self.null = P
        self.k = rng.standard_normal((P + 1, page, hkv, d)).astype(np.float32)
        self.v = rng.standard_normal((P + 1, page, hkv, d)).astype(np.float32)
        perm = rng.permutation(P).astype(np.int32).reshape(b, mp)
        self.positions = np.array([mp * page - 1, 0, page + 1, 2 * page],
                                  np.int32)[:b]
        live = self.positions // page + 1
        self.bt = np.where(np.arange(mp)[None] < live[:, None], perm,
                           self.null).astype(np.int32)
        self.quant = quant
        if quant:
            tq, jq = QUANT[quant]
            qk, sk = jax_quantize(jnp.asarray(self.k), jq)
            qv, sv = jax_quantize(jnp.asarray(self.v), jq)
            self.jk, self.jv, self.jks, self.jvs = qk, qv, sk, sv
            self.tk = torch.from_numpy(np.array(qk).view(np.uint8)).view(tq) \
                if quant == "fp8" else torch.from_numpy(np.array(qk))
            self.tv = torch.from_numpy(np.array(qv).view(np.uint8)).view(tq) \
                if quant == "fp8" else torch.from_numpy(np.array(qv))
            self.tks = torch.from_numpy(np.array(sk))
            self.tvs = torch.from_numpy(np.array(sv))
        else:
            self.jk, self.jv = jnp.asarray(self.k), jnp.asarray(self.v)
            self.jks = self.jvs = None
            self.tk, self.tv = torch.from_numpy(self.k), torch.from_numpy(self.v)
            self.tks = self.tvs = None
        self.rng = rng

    def holes(self):
        """Compacted-table page positions: every other column keeps its
        logical position, the rest are POS_PAD holes."""
        ppos = (np.arange(self.mp, dtype=np.int32) * self.page)[None].repeat(
            len(self.bt), 0)
        ppos[:, 1::2] = pa.POS_PAD
        return ppos


def _cmp(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _decode(case, q, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "page_positions" in kw:
        jkw["page_positions"] = jnp.asarray(kw["page_positions"])
        tkw["page_positions"] = torch.from_numpy(kw["page_positions"])
    want = paged_decode_attention_ref(
        jnp.asarray(q), case.jk, case.jv, jnp.asarray(case.bt),
        jnp.asarray(case.positions), k_scale=case.jks, v_scale=case.jvs,
        **jkw)
    got = pa.paged_decode_attention(
        torch.from_numpy(q), case.tk, case.tv, torch.from_numpy(case.bt),
        torch.from_numpy(case.positions), k_scale=case.tks,
        v_scale=case.tvs, **tkw)
    return got, want


def _prefill(case, q, start, clen, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "page_positions" in kw:
        jkw["page_positions"] = jnp.asarray(kw["page_positions"])
        tkw["page_positions"] = torch.from_numpy(kw["page_positions"])
    want = paged_prefill_attention_ref(
        jnp.asarray(q), case.jk, case.jv, jnp.asarray(case.bt),
        jnp.asarray(start), jnp.asarray(clen), k_scale=case.jks,
        v_scale=case.jvs, **jkw)
    got = pp.paged_prefill_attention(
        torch.from_numpy(q), case.tk, case.tv, torch.from_numpy(case.bt),
        torch.from_numpy(start), torch.from_numpy(clen), k_scale=case.tks,
        v_scale=case.tvs, **tkw)
    return got, want


def _chunk(case, c):
    """Ragged chunk geometry: a full row, a short row at position 0, an
    inert row (chunk_len 0), and a row starting mid-sequence."""
    cap = case.mp * case.page
    start = np.array([0, 0, 3, min(case.page + 1, cap - c)], np.int32)
    clen = np.array([c, max(1, c // 3), 0, c], np.int32)
    return start, clen


@pytest.mark.parametrize("group,d,page", GEOMETRY)
def test_plain_decode_matches_reference(group, d, page):
    case = Case(10, group, d, page)
    q = case.rng.standard_normal((4, case.hq, d)).astype(np.float32)
    got, want = _decode(case, q)
    assert got.dtype == torch.float32 and got.shape == (4, case.hq, d)
    _cmp(got, want)


@pytest.mark.parametrize("group,d,page", GEOMETRY)
def test_plain_prefill_matches_reference(group, d, page):
    case = Case(11, group, d, page)
    c = 5
    q = case.rng.standard_normal((4, c, case.hq, d)).astype(np.float32)
    start, clen = _chunk(case, c)
    got, want = _prefill(case, q, start, clen)
    _cmp(got, want)
    assert not got[2].any()                      # inert row: exact zeros
    assert not got[1, clen[1]:].any()            # ragged tail: exact zeros


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plain_partials_with_pos_pad_holes_match_reference(kind):
    case = Case(12, 2, 32, 8)
    ppos = case.holes()
    if kind == "decode":
        q = case.rng.standard_normal((4, case.hq, 32)).astype(np.float32)
        got, want = _decode(case, q, page_positions=ppos, partials=True)
    else:
        q = case.rng.standard_normal((4, 6, case.hq, 32)).astype(np.float32)
        start, clen = _chunk(case, 6)
        got, want = _prefill(case, q, start, clen, page_positions=ppos,
                             partials=True)
    assert len(got) == 3 and all(g.dtype == torch.float32 for g in got)
    _cmp(got, want)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("partials", [False, True])
def test_plain_quantized_pages_match_reference(quant, kind, partials):
    case = Case(13, 2, 16, 4, quant=quant)
    kw = dict(partials=True) if partials else {}
    if kind == "decode":
        q = case.rng.standard_normal((4, case.hq, 16)).astype(np.float32)
        got, want = _decode(case, q, **kw)
    else:
        q = case.rng.standard_normal((4, 7, case.hq, 16)).astype(np.float32)
        start, clen = _chunk(case, 7)
        got, want = _prefill(case, q, start, clen, **kw)
    _cmp(got, want)


# ---------------------------------------- the bf16 decode kernel's splits
#
# The tensor-core decode kernel cuts the table into splits of whole pages,
# reduces each to an f32 carry and merges them by log-sum-exp.  Its plain
# form is held against both reference oracles: the gather formulation,
# and the reference's own two-pass split-and-merge (per-page partials
# merged by `kernel.combine_pages`).  With pages of 4 or 8 and 6 columns,
# row 1 (position 0) leaves every split but the first empty, and the
# holes table leaves splits of one page that hold only POS_PAD.

# pages per split: one, two, four, and the kernel's rule (128 tokens)
SPLIT_PAGES = [1, 2, 4, None]


@pytest.mark.parametrize("pages_per_split", SPLIT_PAGES)
@pytest.mark.parametrize("mode", ["plain", "partials", "holes+partials"])
def test_split_decode_plain_matches_reference(pages_per_split, mode):
    case = Case(15, 2, 32, 8)
    q = case.rng.standard_normal((4, case.hq, 32)).astype(np.float32)
    kw = {}
    if mode != "plain":
        kw["partials"] = True
    if mode == "holes+partials":
        kw["page_positions"] = case.holes()
    want = paged_decode_attention_ref(
        jnp.asarray(q), case.jk, case.jv, jnp.asarray(case.bt),
        jnp.asarray(case.positions),
        **{k: jnp.asarray(v) if k == "page_positions" else v
           for k, v in kw.items()})
    got = pa.paged_decode_attention_splits_plain(
        torch.from_numpy(q), case.tk, case.tv, torch.from_numpy(case.bt),
        torch.from_numpy(case.positions), pages_per_split=pages_per_split,
        **{k: torch.from_numpy(v) if k == "page_positions" else v
           for k, v in kw.items()})
    _cmp(got, want)
    if mode != "plain":
        m, l, acc = got
        assert (l > 0).all()


@pytest.mark.parametrize("pages_per_split", SPLIT_PAGES)
@pytest.mark.parametrize("group,d,page", [(1, 16, 4), (2, 128, 4),
                                          (4, 32, 4)])
def test_split_decode_plain_matches_the_reference_two_pass_merge(
        pages_per_split, group, d, page):
    case = Case(16, group, d, page)
    q = case.rng.standard_normal((4, case.hq, d)).astype(np.float32)
    want = paged_decode_attention_split_ref(
        jnp.asarray(q), case.jk, case.jv, jnp.asarray(case.bt),
        jnp.asarray(case.positions))
    got = pa.paged_decode_attention_splits_plain(
        torch.from_numpy(q), case.tk, case.tv, torch.from_numpy(case.bt),
        torch.from_numpy(case.positions), pages_per_split=pages_per_split)
    _cmp(got, want)


@pytest.mark.parametrize("pages_per_split", SPLIT_PAGES)
def test_split_decode_plain_keeps_an_all_hole_row_empty(pages_per_split):
    # every column of rows 1 and 2 a POS_PAD hole: each split is empty,
    # and the merged carry is the reference's empty one (m = -1e30, l = 0,
    # acc = 0)
    case = Case(17, 2, 16, 4)
    q = case.rng.standard_normal((4, case.hq, 16)).astype(np.float32)
    ppos = case.holes()
    ppos[1:3] = pa.POS_PAD
    want = paged_decode_attention_ref(
        jnp.asarray(q), case.jk, case.jv, jnp.asarray(case.bt),
        jnp.asarray(case.positions), page_positions=jnp.asarray(ppos),
        partials=True)
    got = pa.paged_decode_attention_splits_plain(
        torch.from_numpy(q), case.tk, case.tv, torch.from_numpy(case.bt),
        torch.from_numpy(case.positions), page_positions=torch.from_numpy(ppos),
        partials=True, pages_per_split=pages_per_split)
    _cmp(got, want)
    m, l, acc = got
    assert (m[1:3] == pa.NEG_INF).all()
    assert not l[1:3].any() and not acc[1:3].any()


# the served bf16 widths beside the matrix: zamba2-2.7b (group 1, d 160)
# and qwen3-moe-30b-a3b (group 8, d 128)
BF16_GEOMETRY = GEOMETRY + [(1, 160, 16), (8, 128, 16)]


@pytest.mark.parametrize("group,d,page", BF16_GEOMETRY)
@pytest.mark.parametrize("mode", ["plain", "holes+partials"])
def test_plain_prefill_in_bf16_and_reference_in_bf16_match_exact_attention(
        group, d, page, mode):
    # what the card runs: bf16 q and pages.  Each bf16 version rounds in
    # its own places (the reference its scores, the plain version p
    # before the PV product, as the TPU kernel does), so each is held by
    # kernels/tolerance.py's bf16 rule to the exact answer on the same
    # bf16 inputs: the reference evaluated in f32
    case = Case(14, group, d, page)
    c = 7
    q = case.rng.standard_normal((4, c, case.hq, d)).astype(np.float32)
    start, clen = _chunk(case, c)
    ppos = case.holes() if mode != "plain" else None
    partials = mode != "plain"

    def ref(dtype):
        args = [jnp.asarray(x, jnp.bfloat16).astype(dtype)
                for x in (q, case.k, case.v)]
        out = paged_prefill_attention_ref(
            *args, jnp.asarray(case.bt), jnp.asarray(start),
            jnp.asarray(clen), partials=partials,
            page_positions=None if ppos is None else jnp.asarray(ppos))
        return tuple(torch.from_numpy(np.array(o.astype(jnp.float32)))
                     for o in (out if partials else (out,)))

    got = pp.paged_prefill_attention(
        torch.from_numpy(q).bfloat16(), case.tk.bfloat16(),
        case.tv.bfloat16(), torch.from_numpy(case.bt),
        torch.from_numpy(start), torch.from_numpy(clen), partials=partials,
        page_positions=None if ppos is None else torch.from_numpy(ppos))
    if not partials:
        assert got.dtype == torch.bfloat16
        assert not got[2].float().any()            # inert row: exact zeros
        got = (got,)
    exact = ref(jnp.float32)
    tol = TOLERANCE[torch.bfloat16]
    assert worst_ratio(got, exact, *tol)[1] <= 1.0
    assert worst_ratio(ref(jnp.bfloat16), exact, *tol)[1] <= 1.0


# ------------------------------------------------------- quantization

@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_kv_is_bit_exact_with_reference(quant):
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((5, 3, 4, 32)) * 4).astype(np.float32)
    x[0, 1] = 0.0                                    # zero rows -> scale 0
    x[1, 2, 1] = 0.0
    # halfway cases for int8 round-half-even: amax 127 gives scale 1
    x[2, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[2, 0, 0, 4:] = 0.0
    tq, jq = QUANT[quant]
    q_t, s_t = quantize_kv(torch.from_numpy(x), tq)
    q_j, s_j = jax_quantize(jnp.asarray(x), jq)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    carrier = np.uint8 if quant == "fp8" else np.int8
    got = (q_t.view(torch.uint8) if quant == "fp8" else q_t).numpy()
    np.testing.assert_array_equal(got, np.asarray(q_j).view(carrier))
    assert (s_t[0, 1] == 0).all() and (s_t[1, 2, 1] == 0)
    if quant == "int8":
        np.testing.assert_array_equal(got[2, 0, 0, :4], [127, 2, -4, 0])
    np.testing.assert_array_equal(
        dequantize_kv(q_t, s_t).numpy(), np.asarray(jax_dequantize(q_j, s_j)))


def test_fp8_quantize_clips_before_the_cast():
    """Values a hair above the e4m3 range after scaling must saturate at
    448, never become NaN."""
    x = torch.tensor([[[448.0 * 1.0001, 1.0, -448.0 * 1.0001, 3.0]]])
    q, s = quantize_kv(x, torch.float8_e4m3fn)
    deq = dequantize_kv(q, s)
    assert torch.isfinite(deq).all()
    assert q.float().abs().max() == 448.0
