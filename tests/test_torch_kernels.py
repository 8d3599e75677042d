"""The port's CUDA kernels (paged decode and prefill attention, grouped
matmul, SSD intra-chunk, split-KV decode and flash attention over
contiguous K/V) against their plain PyTorch versions, and the wrappers'
routing.

Tests marked `cuda` need the card (the kernels have no CPU mode) and
skip without one; this file imports neither JAX nor the reference, so it
also runs where only PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.unimem import quantize_kv
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dk
from repro_torch.kernels.flash_attention import ops as fk
from repro_torch.kernels.grouped_matmul import ops as gm
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.tolerance import (MAX_DIFFERENT_SHARE, TOLERANCE,
                                          different_share, worst_ratio)

QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, dtype, quant, b=4, group=2, hkv=8, d=128, page=16, mp=64):
    """Main-path geometry: shuffled pages, ragged rows (one at position
    0), null-page table tails."""
    rng = np.random.default_rng(20)
    P = b * mp
    k = torch.from_numpy(rng.standard_normal((P + 1, page, hkv, d),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((P + 1, page, hkv, d),
                                             dtype=np.float32))
    positions = np.array([mp * page - 1, 0, page + 1, 700], np.int32)[:b]
    live = positions // page + 1
    perm = rng.permutation(P).astype(np.int32).reshape(b, mp)
    bt = np.where(np.arange(mp)[None] < live[:, None], perm, P)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k, QUANT[quant]), quantize_kv(v, QUANT[quant])
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    holes = (np.arange(mp, dtype=np.int32) * page)[None].repeat(b, 0)
    holes[:, 1::2] = pa.POS_PAD
    return dict(k=k.to(dev), v=v.to(dev), k_scale=ks, v_scale=vs,
                bt=torch.from_numpy(bt.astype(np.int32)).to(dev),
                positions=torch.from_numpy(positions).to(dev),
                holes=torch.from_numpy(holes).to(dev), hq=group * hkv, d=d,
                page=page, mp=mp)


def _chunk(case, c, dev):
    start = np.array([0, 0, 3, min(case["page"] + 1,
                                   case["mp"] * case["page"] - c)], np.int32)
    clen = np.array([c, max(1, c // 3), 0, c], np.int32)
    return (torch.from_numpy(start).to(dev), torch.from_numpy(clen).to(dev))


def _assert_close(got, want, dtype):
    # per element, |kernel - plain| <= rtol |plain| + atol max |plain row|
    # (kernels/tolerance.py)
    err, ratio = worst_ratio(got, want, *TOLERANCE[dtype])
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("holes", [False, True])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, quant,
                                             holes):
    case = _case(cuda_device, dtype, quant)
    q = torch.randn(4, case["hq"], case["d"], device=cuda_device).to(dtype)
    kw = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    if holes:
        kw.update(page_positions=case["holes"], partials=True)
    args = (q, case["k"], case["v"], case["bt"], case["positions"])
    before = pa.launches
    got = pa.paged_decode_attention(*args, **kw)
    assert pa.launches == before + 1
    _assert_close(got, pa.paged_decode_attention_plain(*args, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 1, 64, "partials"])
def test_f32_queries_over_bf16_pages_match_plain_on_card(cuda_device, c):
    """An f32 model over a `kv_dtype="bf16"` arena: the CUDA-core design
    with bf16 pages (decode for c 0, a prefill chunk of c rows, or
    decode's partials over a table with holes).  The normalized output
    rounds as the plain version does, so it is held at bf16's bound and
    to at most `MAX_DIFFERENT_SHARE` of its elements differing; the
    partials keep p in f32 in both and are held at f32's bound."""
    case = _case(cuda_device, torch.bfloat16, None)
    kv = (case["k"], case["v"], case["bt"])
    decode = c in (0, "partials")
    before = (pa.launches, pp.launches)
    if decode:
        q = torch.randn(4, case["hq"], case["d"], device=cuda_device)
        args = (q, *kv, case["positions"])
        kw = (dict(page_positions=case["holes"], partials=True)
              if c == "partials" else {})
        got = pa.paged_decode_attention(*args, **kw)
        want = pa.paged_decode_attention_plain(*args, **kw)
    else:
        q = torch.randn(4, c, case["hq"], case["d"], device=cuda_device)
        args = (q, *kv, *_chunk(case, c, cuda_device))
        got = pp.paged_prefill_attention(*args)
        want = pp.paged_prefill_attention_plain(*args)
    assert (pa.launches, pp.launches) == (before[0] + decode,
                                          before[1] + (not decode))
    if c == "partials":
        _assert_close(got, want, torch.float32)
        return
    assert got.dtype == torch.float32
    _assert_close(got, want, torch.bfloat16)
    assert different_share(got, want) <= MAX_DIFFERENT_SHARE


@pytest.mark.parametrize("c", [0, 64])
def test_different_share_rejects_bf16_scores(c):
    """The rule that holds the f32-query / bf16-page kernels: the plain
    version with q rounded to bf16 before q.k (what a kernel with a bf16
    score product would compute) differs from the plain version in far
    more than `MAX_DIFFERENT_SHARE` of the elements."""
    case = _case(torch.device("cpu"), torch.bfloat16, None)
    kv = (case["k"], case["v"], case["bt"])
    gen = torch.Generator().manual_seed(c)
    if c == 0:
        q = torch.randn(4, case["hq"], case["d"], generator=gen)
        plain, rest = pa.paged_decode_attention_plain, (case["positions"],)
    else:
        q = torch.randn(4, c, case["hq"], case["d"], generator=gen)
        plain = pp.paged_prefill_attention_plain
        rest = _chunk(case, c, torch.device("cpu"))
    want = plain(q, *kv, *rest)
    assert different_share(want, want) == 0.0
    bf16_scores = plain(q.to(torch.bfloat16).float(), *kv, *rest)
    assert different_share(bf16_scores, want) > 10 * MAX_DIFFERENT_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 7, 64])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_kernel_matches_plain_on_card(cuda_device, dtype, c, quant):
    case = _case(cuda_device, dtype, quant)
    q = torch.randn(4, c, case["hq"], case["d"], device=cuda_device).to(dtype)
    start, clen = _chunk(case, c, cuda_device)
    args = (q, case["k"], case["v"], case["bt"], start, clen)
    kw = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    got = pp.paged_prefill_attention(*args, **kw)
    _assert_close(got, pp.paged_prefill_attention_plain(*args, **kw), dtype)
    assert not got[2].any()                       # inert row: exact zeros


# (group, head_dim, kv heads) of the served bf16 widths: internlm2-1.8b,
# qwen3-moe-30b-a3b, zamba2-2.7b
TC_WIDTHS = [(2, 128, 8), (8, 128, 4), (1, 160, 32)]


def _tc_chunk(case, c, where, dev):
    """start 0 on every row, or mid-sequence; chunk_len full, ragged
    (c // 3) and 0 in both."""
    start = [0, 0, 0, 0] if where == "start" else [959, 0, 448, 600]
    clen = [c, max(1, c // 3), 0, c]
    return (torch.tensor(start, dtype=torch.int32, device=dev),
            torch.tensor(clen, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("group,d,hkv", TC_WIDTHS)
@pytest.mark.parametrize("c", [1, 7, 8, 64])
@pytest.mark.parametrize("where", ["start", "mid"])
def test_tensor_core_prefill_matches_plain_on_card(cuda_device, group, d,
                                                   hkv, c, where):
    case = _case(cuda_device, torch.bfloat16, None, group=group, hkv=hkv,
                 d=d)
    q = torch.randn(4, c, case["hq"], d, device=cuda_device).bfloat16()
    start, clen = _tc_chunk(case, c, where, cuda_device)
    args = (q, case["k"], case["v"], case["bt"], start, clen)
    before = pp.launches
    got = pp.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert pp.launches == before + 1
    _assert_close(got, pp.paged_prefill_attention_plain(*args),
                  torch.bfloat16)
    assert not got[2].any()                       # chunk_len 0: exact zeros
    assert not got[1, max(1, c // 3):].any()      # ragged tail: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("group,d,hkv", TC_WIDTHS)
@pytest.mark.parametrize("c", [7, 64])
def test_tensor_core_prefill_partials_with_holes_match_plain_on_card(
        cuda_device, group, d, hkv, c):
    case = _case(cuda_device, torch.bfloat16, None, group=group, hkv=hkv,
                 d=d)
    q = torch.randn(4, c, case["hq"], d, device=cuda_device).bfloat16()
    start, clen = _tc_chunk(case, c, "mid", cuda_device)
    args = (q, case["k"], case["v"], case["bt"], start, clen)
    kw = dict(page_positions=case["holes"], partials=True)
    got = pp.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pp.paged_prefill_attention_plain(*args, **kw)
    _assert_close(got, want, torch.bfloat16)
    m, l, acc = got
    assert not l[2].any() and not acc[2].any()    # chunk_len 0: empty carry


@pytest.mark.cuda
@pytest.mark.parametrize("page", [4, 48, 128])
@pytest.mark.parametrize("holes", [False, True])
def test_tensor_core_prefill_walks_other_page_sizes(cuda_device, page,
                                                    holes):
    # 16 pages of 4 per tile; a 48-token page padded to a 64-token tile;
    # a 128-token page in two 64-token slices
    case = _case(cuda_device, torch.bfloat16, None, mp=-(-1056 // page),
                 page=page)
    q = torch.randn(4, 64, case["hq"], case["d"],
                    device=cuda_device).bfloat16()
    start, clen = _tc_chunk(case, 64, "mid", cuda_device)
    args = (q, case["k"], case["v"], case["bt"], start, clen)
    kw = dict(page_positions=case["holes"], partials=True) if holes else {}
    got = pp.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(got, pp.paged_prefill_attention_plain(*args, **kw),
                  torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("row, col", [(0, 30), (3, 20)])
def test_tensor_core_prefill_fails_the_check_on_a_page_read_twice(
        cuda_device, row, col):
    case = _case(cuda_device, torch.bfloat16, None)
    q = torch.randn(4, 64, case["hq"], case["d"],
                    device=cuda_device).bfloat16()
    start, clen = _tc_chunk(case, 64, "mid", cuda_device)
    want = pp.paged_prefill_attention_plain(q, case["k"], case["v"],
                                            case["bt"], start, clen)
    bad = case["bt"].clone()
    bad[row, col] = bad[row, col + 1]
    got = pp.paged_prefill_attention(q, case["k"], case["v"], bad, start,
                                     clen)
    torch.cuda.synchronize()
    assert worst_ratio(got, want, *TOLERANCE[torch.bfloat16])[1] > 4.0


@pytest.mark.cuda
def test_tensor_core_prefill_refuses_head_dims_off_its_tiles(cuda_device):
    for d in (24, 40):
        case = _case(cuda_device, torch.bfloat16, None, d=d, mp=8)
        q = torch.randn(4, 8, case["hq"], d, device=cuda_device).bfloat16()
        start, clen = _tc_chunk(case, 8, "start", cuda_device)
        before = pp.launches
        with pytest.raises(ValueError, match="multiples of 16"):
            pp.paged_prefill_attention(q, case["k"], case["v"], case["bt"],
                                       start, clen)
        assert pp.launches == before
        # the CUDA-core design still takes the same width in f32
        got = pp.paged_prefill_attention(q.float(), case["k"].float(),
                                         case["v"].float(), case["bt"],
                                         start, clen)
        _assert_close(got, pp.paged_prefill_attention_plain(
            q.float(), case["k"].float(), case["v"].float(), case["bt"],
            start, clen), torch.float32)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    case = _case(cuda_device, torch.float32, None)
    q = torch.randn(4, case["hq"], case["d"], device=cuda_device)
    k, v, bt, pos = case["k"], case["v"], case["bt"], case["positions"]
    with pytest.raises(ValueError):                 # int64 positions
        pa.paged_decode_attention(q, k, v, bt, pos.long())
    with pytest.raises(ValueError):                 # q / pages dtype mismatch
        pa.paged_decode_attention(q.bfloat16(), k, v, bt, pos)
    with pytest.raises(ValueError):                 # non-contiguous q
        pa.paged_decode_attention(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), k, v, bt, pos)
    with pytest.raises(ValueError):                 # table on the CPU
        pa.paged_decode_attention(q, k, v, bt.cpu(), pos)


def _split_case(dev, group, d, page, hkv=2, seed=22):
    """bf16 arena and table over three splits of the tensor-core decode
    design, rows ending at position 0, on the last token of split 0, on
    the first of split 1, one past it, and past the whole table (an idle
    row); shuffled pages, null-page tails, and a holes table (every
    other column POS_PAD)."""
    split = pa.split_pages(page) * page
    mp = -(-3 * split // page)
    positions = np.array([0, split - 1, split, split + 1, mp * page + 7],
                         np.int32)
    b = len(positions)
    rng = np.random.default_rng(seed)
    P = b * mp
    k, v = (torch.from_numpy(rng.standard_normal((P + 1, page, hkv, d),
                                                 dtype=np.float32))
            for _ in range(2))
    live = np.minimum(positions // page + 1, mp)
    perm = rng.permutation(P).astype(np.int32).reshape(b, mp)
    bt = np.where(np.arange(mp)[None] < live[:, None], perm, P)
    holes = (np.arange(mp, dtype=np.int32) * page)[None].repeat(b, 0)
    holes[:, 1::2] = pa.POS_PAD
    q = torch.from_numpy(rng.standard_normal((b, group * hkv, d),
                                             dtype=np.float32))
    as_dev = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)
    return dict(q=q.bfloat16().to(dev), k=k.bfloat16().to(dev),
                v=v.bfloat16().to(dev), bt=as_dev(bt),
                positions=as_dev(positions), holes=as_dev(holes))


def _tc_decode(case, **kw):
    args = (case["q"], case["k"], case["v"], case["bt"], case["positions"])
    before = pa.launches
    got = pa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    return got, pa.paged_decode_attention_plain(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("mode", ["plain", "holes+partials"])
def test_tensor_core_decode_matches_plain_on_card(cuda_device, group, d,
                                                  mode):
    case = _split_case(cuda_device, group, d, 16)
    kw = ({} if mode == "plain"
          else dict(page_positions=case["holes"], partials=True))
    got, want = _tc_decode(case, **kw)
    _assert_close(got, want, torch.bfloat16)
    if mode == "plain":
        assert got.dtype == torch.bfloat16
    else:
        assert all(t.dtype == torch.float32 for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [4, 16, 48, 128])
@pytest.mark.parametrize("holes", [False, True])
def test_tensor_core_decode_walks_other_page_sizes(cuda_device, page, holes):
    # 32 pages of 4 per split in 16-page tiles; a 48-token page padded
    # to a 64-token tile, two per split; one 128-token page per split in
    # two 64-token slices
    case = _split_case(cuda_device, 2, 128, page)
    kw = dict(page_positions=case["holes"], partials=True) if holes else {}
    got, want = _tc_decode(case, **kw)
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_tensor_core_decode_partials_keep_the_empty_carry(cuda_device):
    # a row whose every visible column is a POS_PAD hole: m = -1e30,
    # l = 0, acc = 0, as the plain version keeps them
    case = _split_case(cuda_device, 2, 128, 16)
    holes = case["holes"].clone()
    holes[1:3] = pa.POS_PAD
    m, l, acc = _tc_decode(case, page_positions=holes, partials=True)[0]
    assert (m[1:3] == pa.NEG_INF).all()
    assert not l[1:3].any() and not acc[1:3].any()


@pytest.mark.cuda
def test_tensor_core_decode_resets_its_merge_counters(cuda_device):
    # the last split of each (batch row, kv head) resets its counter, so
    # the same call twice gives the same bits and leaves them at 0
    case = _split_case(cuda_device, 8, 128, 16, hkv=4)
    first, want = _tc_decode(case)
    second, _ = _tc_decode(case)
    assert torch.equal(first, second)
    _assert_close(second, want, torch.bfloat16)
    tickets = pa._SCRATCH[case["q"].device][1]
    assert not tickets.any()


@pytest.mark.cuda
@pytest.mark.parametrize("row, col", [(1, 0), (4, 20)])
def test_tensor_core_decode_fails_the_check_on_a_page_read_twice(
        cuda_device, row, col):
    case = _split_case(cuda_device, 2, 128, 16)
    want = pa.paged_decode_attention_plain(case["q"], case["k"], case["v"],
                                           case["bt"], case["positions"])
    bad = case["bt"].clone()
    bad[row, col] = bad[row, col + 1]
    got = pa.paged_decode_attention(case["q"], case["k"], case["v"], bad,
                                    case["positions"])
    torch.cuda.synchronize()
    assert worst_ratio(got, want, *TOLERANCE[torch.bfloat16])[1] > 4.0


@pytest.mark.cuda
def test_tensor_core_decode_refuses_what_its_tiles_do_not_take(cuda_device):
    for d in (24, 40):
        case = _case(cuda_device, torch.bfloat16, None, d=d, mp=8)
        q = torch.randn(4, case["hq"], d, device=cuda_device).bfloat16()
        args = (case["k"], case["v"], case["bt"],
                torch.clamp(case["positions"], max=127))
        before = pa.launches
        with pytest.raises(ValueError, match="multiples of 16"):
            pa.paged_decode_attention(q, *args)
        assert pa.launches == before
        # the CUDA-core design still takes the same width in f32
        f32 = (q.float(), case["k"].float(), case["v"].float(), *args[2:])
        _assert_close(pa.paged_decode_attention(*f32),
                      pa.paged_decode_attention_plain(*f32), torch.float32)
    case = _case(cuda_device, torch.bfloat16, None, group=32, hkv=2, d=16,
                 mp=8)
    q = torch.randn(4, 64, 16, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="at most 16"):
        pa.paged_decode_attention(q, case["k"], case["v"], case["bt"],
                                  torch.clamp(case["positions"], max=127))


def _grouped_case(dev, dtype, E, C, K, F, live, dead=0.0):
    """x with only its first rows[e] rows nonzero (the dropless buffer),
    w, and rows; `live` False leaves rows None, True draws rows, a tuple
    gives them.  `dead` fills x's rows past rows[e] (0 in the buffer)."""
    rng = np.random.default_rng(E + C + K)
    x = torch.from_numpy(rng.standard_normal((E, C, K), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((E, K, F), dtype=np.float32)
                         * 0.05)
    rows = None
    if live is not False:
        if live is True:
            r = rng.integers(0, max(2, C // 16), E).astype(np.int32)
            r[::3] = 0
            r[1] = C                              # one expert full
        else:
            r = np.array(live, np.int32)
        x = torch.where(torch.from_numpy(np.arange(C)[None, :, None]
                                         < r[:, None, None]), x,
                        torch.tensor(dead))
        rows = torch.from_numpy(r).to(dev)
    return x.to(dtype).to(dev), w.to(dtype).to(dev), rows


# (E, C, K, F, live): qwen3's decode shapes; every row; ragged C, K, F
# (unaligned: element copies); one expert at each live count around the
# m16 tiles, a dead expert first; 130 live rows across three row ranges
# of C 300; K 136 (the ring's last slice partial) with 17 live rows of
# C 80 and F 72 (a partial n tile); K 36 and F 72 (element copies)
GROUPED_CASES = [
    (128, 64, 2048, 768, True),         # qwen3 decode, gate/up
    (128, 64, 768, 2048, True),         # qwen3 decode, down
    (16, 300, 256, 192, False),
    (3, 37, 19, 45, True),              # ragged C, K, F: masked edges
    (7, 64, 256, 192, (0, 1, 15, 16, 17, 63, 64)),
    (2, 300, 128, 128, (0, 130)),
    (3, 80, 136, 72, (0, 17, 80)),
    (3, 80, 36, 72, (0, 17, 80))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E, C, K, F, live", GROUPED_CASES)
def test_grouped_kernel_matches_plain_on_card(cuda_device, dtype, E, C, K, F,
                                              live):
    x, w, rows = _grouped_case(cuda_device, dtype, E, C, K, F, live)
    before = gm.launches
    got = gm.grouped_matmul(x, w, rows)
    assert gm.launches == before + 1 and got.dtype == torch.float32
    want = gm.grouped_matmul_plain(x, w, rows)
    err, ratio = worst_ratio(got, want, *gm.TOLERANCE[dtype])
    assert ratio <= 1.0, (err, ratio)
    if rows is not None:
        assert not got[0].any()                   # a dead expert: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E, C, K, F, live", GROUPED_CASES[4:7])
def test_grouped_kernel_never_reads_the_rows_past_the_live_count(
        cuda_device, dtype, E, C, K, F, live):
    """NaN in x's dead rows: the live rows stay finite and hold the plain
    version on the zeroed buffer, the dead rows are exact zeros."""
    x, w, rows = _grouped_case(cuda_device, dtype, E, C, K, F, live,
                               dead=float("nan"))
    got = gm.grouped_matmul(x, w, rows)
    want = gm.grouped_matmul_plain(torch.nan_to_num(x, nan=0.0), w, rows)
    keep = (torch.arange(C, device=cuda_device)[None, :]
            < rows[:, None].long())[..., None].expand_as(got)
    assert torch.isfinite(got).all()
    assert torch.equal(got[~keep], torch.zeros_like(got[~keep]))
    err, ratio = worst_ratio(got, want, *gm.TOLERANCE[dtype])
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernel_reruns_are_bit_identical(cuda_device, dtype):
    x, w, rows = _grouped_case(cuda_device, dtype, 128, 64, 2048, 768, True)
    first = gm.grouped_matmul(x, w, rows)
    for _ in range(3):
        assert torch.equal(gm.grouped_matmul(x, w, rows), first)


@pytest.mark.cuda
def test_grouped_occupancy_matches_the_mirror(cuda_device):
    assert gm.launched_blocks_per_sm(True) == gm.blocks_per_sm()
    assert gm.launched_blocks_per_sm(False) == gm.blocks_per_sm()


def test_grouped_geometry_keeps_the_decode_blocks_in_one_wave():
    """The bf16 block's shared memory (its stated terms) lets five share
    an SM, so qwen3's decode (about 52 live experts x 12 n tiles of the
    gate/up shape) fits one wave of 132 SMs; C 4096 has 64 row ranges."""
    assert gm.smem_bytes() == 38_912
    assert gm.blocks_per_sm() == 5
    assert gm.grid(128, 64, 768) == (12, 128, 1)
    assert gm.grid(128, 64, 2048) == (32, 128, 1)
    assert gm.grid(128, 4096, 768) == (12, 128, 64)
    assert gm.grid(3, 37, 45) == (1, 3, 1)
    assert 52 * gm.grid(128, 64, 768)[0] <= 132 * gm.blocks_per_sm()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh, nc, l, p, n", [(640, 1, 64, 64, 64),
                                             (160, 1, 256, 64, 64),
                                             (6, 3, 13, 16, 24),
                                             (4, 2, 128, 128, 128),
                                             (24, 2, 256, 64, 128),
                                             # ragged chunks at n 128
                                             (24, 1, 200, 64, 128),
                                             (24, 1, 5, 64, 128),
                                             # 63 bf16 blocks, p and n
                                             # off the 16 grid
                                             (7, 3, 100, 24, 40)])
def test_ssd_kernel_matches_plain_on_card(cuda_device, dtype, bh, nc, l, p,
                                          n):
    if ssd.smem_bytes(dtype, l, p, n) > ssd.MAX_SMEM:
        pytest.skip("needs more shared memory than a block has")
    rng = np.random.default_rng(l)
    x = torch.from_numpy(rng.standard_normal((bh, nc, l, p), dtype=np.float32))
    B = torch.from_numpy(rng.standard_normal((bh, nc, l, n), dtype=np.float32))
    C = torch.from_numpy(rng.standard_normal((bh, nc, l, n), dtype=np.float32))
    dt = torch.from_numpy((rng.random((bh, nc, l)) * 0.1).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, bh)
    args = [t.to(dtype).to(cuda_device) for t in (x,)] + [
        dt.to(cuda_device), A.to(cuda_device)] + [
        t.to(dtype).to(cuda_device) for t in (B, C)]
    before = ssd.launches
    got = ssd.ssd_intra_chunk(*args)
    assert ssd.launches == before + 1
    want = ssd.ssd_intra_chunk_plain(*args)
    for g, w_ in zip(got, want):
        err, ratio = worst_ratio(g, w_, *ssd.TOLERANCE[dtype])
        assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
def test_new_kernel_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    x, w, rows = _grouped_case(cuda_device, torch.float32, 4, 8, 16, 8, True)
    with pytest.raises(ValueError):                 # dtype mismatch
        gm.grouped_matmul(x, w.bfloat16(), rows)
    with pytest.raises(ValueError):                 # int64 rows
        gm.grouped_matmul(x, w, rows.long())
    with pytest.raises(ValueError):                 # rows on the CPU
        gm.grouped_matmul(x, w, rows.cpu())
    with pytest.raises(ValueError):                 # non-contiguous w
        gm.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2),
                          rows)
    xs = torch.zeros(2, 1, 16, 12, device=cuda_device)
    dt = torch.zeros(2, 1, 16, device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    Bs = torch.zeros(2, 1, 16, 8, device=cuda_device)
    with pytest.raises(ValueError):                 # p not a multiple of 8
        ssd.ssd_intra_chunk(xs, dt, A, Bs, Bs)
    with pytest.raises(ValueError):                 # chunk past 256
        ssd.ssd_intra_chunk(torch.zeros(2, 1, 300, 8, device=cuda_device),
                            torch.zeros(2, 1, 300, device=cuda_device), A,
                            torch.zeros(2, 1, 300, 8, device=cuda_device),
                            torch.zeros(2, 1, 300, 8, device=cuda_device))


# (b, hq, hkv, d, S, positions): the contiguous decode shape with an idle
# row past S, zamba2's shared attention (hq = hkv = 32, d 160), and a
# tiny cache whose S is not a multiple of the 8 splits
SPLIT_CASES = [(8, 16, 8, 128, 1024, (1023, 0, 511, 17, 700, 64, 255, 1500)),
               (2, 32, 32, 160, 1000, (5, 999)),
               (3, 4, 2, 16, 61, (0, 60, 70))]
# (b, sq, skv, hq, hkv, d, causal, q_offset): prompts of 5, 200 and 511
# (internlm2 heads), non-causal ragged, a chunk at an offset, zamba2's
# shared attention, and a tiny GQA case
FLASH_CASES = [(1, 5, 5, 16, 8, 128, True, 0), (1, 200, 200, 16, 8, 128, True, 0),
               (1, 511, 511, 16, 8, 128, True, 0),
               (2, 100, 130, 16, 8, 128, False, 0),
               (1, 64, 300, 16, 8, 128, True, 236),
               (1, 77, 77, 32, 32, 160, True, 0), (2, 40, 40, 4, 2, 16, True, 0)]


def _split_inputs(dev, dtype, b, hq, hkv, d, S, positions):
    g = torch.Generator().manual_seed(31)
    q = torch.randn(b, hq, d, generator=g).to(dev, dtype)
    k = torch.randn(b, S, hkv, d, generator=g).to(dev, dtype)
    v = torch.randn(b, S, hkv, d, generator=g).to(dev, dtype)
    return q, k, v, torch.tensor(positions, dtype=torch.int32, device=dev)


def _flash_inputs(dev, dtype, b, sq, skv, hq, hkv, d):
    g = torch.Generator().manual_seed(32)
    return (torch.randn(b, sq, hq, d, generator=g).to(dev, dtype),
            torch.randn(b, skv, hkv, d, generator=g).to(dev, dtype),
            torch.randn(b, skv, hkv, d, generator=g).to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"b{c[0]}-S{c[4]}")
def test_split_decode_kernel_matches_plain_on_card(cuda_device, dtype, case):
    args = _split_inputs(cuda_device, dtype, *case)
    before = dk.launches
    got = dk.decode_attention(*args)
    parts = dk.decode_partials(*args)
    assert dk.launches == before + 2
    torch.cuda.synchronize()
    _assert_close(got, dk.decode_attention_plain(*args), dtype)
    _assert_close(parts[2], dk.decode_partials_plain(*args)[2], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"sq{c[1]}-skv{c[2]}-h{c[3]}-"
                                       f"{'causal' if c[6] else 'full'}-off{c[7]}")
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, case):
    b, sq, skv, hq, hkv, d, causal, off = case
    q, k, v = _flash_inputs(cuda_device, dtype, b, sq, skv, hq, hkv, d)
    before = fk.launches
    got = fk.flash_attention(q, k, v, causal=causal, q_offset=off)
    assert fk.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(got, fk.flash_attention_plain(q, k, v, causal=causal,
                                                q_offset=off), dtype)


# (b, sq, skv, causal, q_offset) at internlm2's heads: prompts of 1, 5,
# 63, 64, 65 and 511 tokens, chunks whose keys run past sq at an offset
# (skv not a multiple of 64), keys past the causal diagonal, non-causal
TC_LENGTHS = [(1, 1, 1, True, 0), (1, 5, 5, True, 0), (2, 63, 63, True, 0),
              (1, 64, 64, True, 0), (1, 65, 65, True, 0),
              (1, 511, 511, True, 0), (1, 65, 300, True, 235),
              (2, 64, 200, True, 100), (1, 1, 257, True, 256),
              (2, 100, 130, False, 0), (1, 63, 100, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_tensor_cores_match_plain_across_widths(cuda_device, group, d):
    # 2 kv heads, a 77-token prompt (ragged packed tiles at every group)
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, 2, 77, 77,
                            2 * group, 2, d)
    before = fk.launches
    got = fk.flash_attention(q, k, v)
    assert fk.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(got, fk.flash_attention_plain(q, k, v), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_LENGTHS,
                         ids=lambda c: f"b{c[0]}-sq{c[1]}-skv{c[2]}-"
                                       f"{'causal' if c[3] else 'full'}-off{c[4]}")
def test_flash_tensor_cores_match_plain_across_lengths(cuda_device, case):
    b, sq, skv, causal, off = case
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, b, sq, skv, 16, 8,
                            128)
    got = fk.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    _assert_close(got, fk.flash_attention_plain(q, k, v, causal=causal,
                                                q_offset=off), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"b{c[0]}-S{c[4]}")
def test_combine_kernel_matches_plain_on_card(cuda_device, dtype, case):
    # the plain split summaries: empty splits (position 0, short rows), a
    # position past S, S not a multiple of the 8 splits (S 61); and one
    # (batch row, kv head) whose every split is empty gives exact zeros
    q, k, v, pos = _split_inputs(cuda_device, dtype, *case)
    b, hq, d = q.shape
    m, l, acc = (t.contiguous() for t in dk.decode_partials_plain(q, k, v, pos))
    m[0], l[0], acc[0] = dk.NEG_INF, 0.0, 0.0
    before = (dk.launches, dk.COMBINE.launches)
    got = dk.combine_splits_kernel(m, l, acc, b, hq, d, dtype)
    assert (dk.launches, dk.COMBINE.launches) == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    want = dk.combine_splits(m, l, acc, b, hq, d, dtype)
    _assert_close(got, want, dtype)
    g = m.shape[2]
    assert not got.reshape(-1, d)[:g].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_launches_the_split_and_the_combine_once(
        cuda_device, dtype):
    # bf16: one launch of the tensor-core kernel, which merges its own
    # splits; f32: the split kernel, then the combine kernel
    args = _split_inputs(cuda_device, dtype, *SPLIT_CASES[0])
    before = (dk.launches, dk.COMBINE.launches)
    got = dk.decode_attention(*args)
    combines = 1 if dtype == torch.float32 else 0
    assert (dk.launches, dk.COMBINE.launches) == (before[0] + 1,
                                                  before[1] + combines)
    torch.cuda.synchronize()
    _assert_close(got, dk.decode_attention_plain(*args), dtype)


def _contig_tc_case(dev, group, d, S, hkv=2, seed=23):
    """bf16 q and caches for the tensor-core split-KV decode: rows at
    position 0, mid-way through split 0, on the first row of split 1,
    at S - 1, past S (an idle row: every row visible) and mid-cache
    (kv_splits 8).  Returns the inputs with every cache row past its
    batch row's position set to NaN, and the clean caches."""
    L = dk.split_len(S, 8)
    positions = [0, L // 2, L, S - 1, S + 7, S // 2]
    rng = np.random.default_rng(seed)
    b = len(positions)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, group * hkv, d), (b, S, hkv, d),
                             (b, S, hkv, d)))
    as_dev = lambda x: torch.from_numpy(x).bfloat16().to(dev)
    clean = as_dev(k), as_dev(v)
    unread = np.arange(S)[None, :] > np.array(positions)[:, None]
    k[unread], v[unread] = np.nan, np.nan
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return (as_dev(q), as_dev(k), as_dev(v), pos), clean


@pytest.mark.cuda
@pytest.mark.parametrize("S", [61, 1000])
@pytest.mark.parametrize("d", [16, 64, 128, 160, 256])
@pytest.mark.parametrize("group", [1, 2, 8, 16])
def test_tensor_core_split_decode_matches_plain_on_card(cuda_device, group,
                                                        d, S):
    # NaN in every row past each position: the kernel never reads them,
    # so it gives the plain version's result on the clean caches
    (q, k, v, pos), (kc, vc) = _contig_tc_case(cuda_device, group, d, S)
    assert dk.route(q.dtype) == dk.TENSOR_CORES
    before = (dk.launches, dk.COMBINE.launches)
    got = dk.decode_attention(q, k, v, pos)
    parts = dk.decode_partials(q, k, v, pos)
    assert (dk.launches, dk.COMBINE.launches) == (before[0] + 2, before[1])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _assert_close(got, dk.decode_attention_plain(q, kc, vc, pos),
                  torch.bfloat16)
    want = dk.decode_partials_plain(q, kc, vc, pos)
    for g_, w_ in zip(parts, want):
        assert g_.shape == w_.shape and g_.dtype == torch.float32
        _assert_close(g_, w_, torch.bfloat16)


@pytest.mark.cuda
def test_tensor_core_split_decode_partials_keep_the_empty_carry(cuda_device):
    # every split that starts past a row's position: m = -1e30, l = 0,
    # acc = 0, as the plain version writes them; the others hold their
    # own split's summary
    (q, k, v, pos), (kc, vc) = _contig_tc_case(cuda_device, 8, 128, 1000)
    m, l, acc = dk.decode_partials(q, k, v, pos)
    torch.cuda.synchronize()
    L, hkv = dk.split_len(1000, 8), k.shape[2]
    live = torch.clamp(pos.long(), max=999) // L + 1          # (b,)
    empty = (torch.arange(8, device=cuda_device)[None, :]
             >= live[:, None]).repeat_interleave(hkv, 0)      # (b * hkv, 8)
    assert empty.any() and (~empty).any()
    assert (m[empty] == dk.NEG_INF).all()
    assert not l[empty].any() and not acc[empty].any()
    assert (l[~empty] > 0).all()
    wm, wl, wacc = dk.decode_partials_plain(q, kc, vc, pos)
    assert torch.equal(wm[empty], m[empty])
    for got, want in ((m, wm), (l, wl), (acc, wacc)):
        _assert_close(got[~empty], want[~empty], torch.bfloat16)


@pytest.mark.cuda
def test_tensor_core_split_decode_resets_its_merge_counters(cuda_device):
    # the last live split of each (batch row, kv head) resets its ticket,
    # so back-to-back calls give the same bits and leave them all at 0
    (q, k, v, pos), _ = _contig_tc_case(cuda_device, 8, 128, 1000, hkv=4)
    first = dk.decode_attention(q, k, v, pos)
    second = dk.decode_attention(q, k, v, pos)
    third = dk.decode_attention(q[:2], k[:2], v[:2], pos[:2])
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(third, first[:2])
    assert not pa._SCRATCH[q.device][1].any()


@pytest.mark.cuda
def test_tensor_core_split_decode_refuses_what_its_tiles_do_not_take(
        cuda_device):
    for d in (24, 40):
        q, k, v, pos = _split_inputs(cuda_device, torch.bfloat16, 2, 4, 2,
                                     d, 61, (0, 60))
        before = (dk.launches, dk.COMBINE.launches)
        with pytest.raises(ValueError, match="multiples of 16"):
            dk.decode_attention(q, k, v, pos)
        with pytest.raises(ValueError, match="multiples of 16"):
            dk.decode_partials(q, k, v, pos)
        assert (dk.launches, dk.COMBINE.launches) == before
        # the CUDA-core design still takes the same width in f32
        f32 = (q.float(), k.float(), v.float(), pos)
        _assert_close(dk.decode_attention(*f32),
                      dk.decode_attention_plain(*f32), torch.float32)
    q, k, v, pos = _split_inputs(cuda_device, torch.bfloat16, 2, 34, 2, 16,
                                 61, (0, 60))
    with pytest.raises(ValueError, match="at most 16"):
        dk.decode_attention(q, k, v, pos)


@pytest.mark.cuda
def test_contiguous_kernel_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    q, k, v, pos = _split_inputs(cuda_device, torch.float32,
                                 *SPLIT_CASES[2])
    with pytest.raises(ValueError):                 # int64 positions
        dk.decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError):                 # caches of another dtype
        dk.decode_attention(q, k.bfloat16(), v.bfloat16(), pos)
    with pytest.raises(ValueError):                 # non-contiguous cache
        dk.decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                            v, pos)
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, 1, 8, 8, 4, 2, 24)
    with pytest.raises(ValueError):                 # d not a multiple of 16
        fk.flash_attention(q, k, v)
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, 1, 8, 8, 4, 2, 16)
    with pytest.raises(ValueError):                 # negative q_offset
        fk.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError):                 # k, v of another dtype
        fk.flash_attention(q, k.float(), v.float())


# ------------------------------------------------------ routing (CPU)

def test_cpu_tensors_take_the_split_decode_and_flash_plain_versions():
    cpu = torch.device("cpu")
    args = _split_inputs(cpu, torch.float32, *SPLIT_CASES[2])
    before = (dk.launches, dk.COMBINE.launches, fk.launches)
    torch.testing.assert_close(dk.decode_attention(*args),
                               dk.decode_attention_plain(*args),
                               rtol=0, atol=0)
    q, k, v = _flash_inputs(cpu, torch.float32, 2, 40, 40, 4, 2, 16)
    torch.testing.assert_close(fk.flash_attention(q, k, v, q_offset=3),
                               fk.flash_attention_plain(q, k, v, q_offset=3),
                               rtol=0, atol=0)
    assert (dk.launches, dk.COMBINE.launches, fk.launches) == before
    with pytest.raises(ValueError, match="runs on cuda"):
        dk.combine_splits_kernel(*dk.decode_partials(*args), 3, 4, 16,
                                 torch.float32)
    other = OtherDevice(2, 4, 16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.decode_attention(other, other, other, other)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fk.flash_attention(other, other, other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_and_flash_shared_memory_fits_the_main_path_widths(dtype):
    # the wrappers refuse a layout past a block's 227 KB: every width the
    # port serves (head_dim 16 to 160, GQA groups of 1 and 2) fits.  bf16
    # takes the tensor-core layout (Q and a 2-stage K/V ring, bf16), f32
    # the CUDA-core one
    for d in (16, 32, 128, 160, 256):
        assert fk.smem_bytes(dtype, d) <= fk.MAX_SMEM
        for g in (1, 2):
            assert dk.smem_bytes(g, d) <= dk.MAX_SMEM
    if dtype == torch.bfloat16:
        assert fk.smem_bytes(dtype, 128) == fk.tc_smem_bytes(128) == 87_040
        assert fk.tc_smem_bytes(160) == 107_520


def test_split_decode_routes_by_dtype():
    assert dk.route(torch.bfloat16) == dk.TENSOR_CORES
    assert dk.route(torch.float32) == dk.CUDA_CORES


def test_split_decode_tensor_core_shared_memory_mirror():
    # Q [16][d + 8] bf16, then the larger of the 2-stage K/V ring [2][2]
    # [64][d + 8] bf16 and the merges' floats (decode_attention.cu
    # dec_tc::smem_bytes)
    assert dk.tc_smem_bytes(128, 8) == 2 * 16 * 136 + 2 * 2 * 2 * 64 * 136 \
        == 73_984
    assert dk.tc_smem_bytes(16, 8) == 768 + 12_288
    assert dk.tc_smem_bytes(160, 8) == 2 * 16 * 168 + 2 * 2 * 2 * 64 * 168
    assert dk.tc_smem_bytes(256, 8) == 143_616
    # many splits: the merge's m and l per split outgrow the ring
    assert dk.tc_smem_bytes(16, 1000) == 768 + 4 * 2002 * 16
    # every head dim the kernel takes fits at the default 8 splits, three
    # blocks per SM at internlm2's d 128
    for d in range(16, dk.MAX_HEAD_DIM + 1, 16):
        assert dk.tc_smem_bytes(d, 8) <= dk.MAX_SMEM
    assert 3 * dk.tc_smem_bytes(128, 8) <= dk.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_input_checks(dtype):
    # the checks run before any launch, so CPU tensors show them
    def inputs(b=2, hq=4, hkv=2, d=16, S=61):
        return _split_inputs(torch.device("cpu"), dtype, b, hq, hkv, d, S,
                             (0, S - 1)[:b])
    dk.check_inputs(*inputs(), 8)
    dk.check_inputs(*inputs(hq=32, hkv=2, d=256), 8)
    bf16 = dtype == torch.bfloat16
    for kw, what in ((dict(d=24), "multiples of 16"),
                     (dict(hq=34, hkv=2), "at most 16")):
        if bf16:
            with pytest.raises(ValueError, match=what):
                dk.check_inputs(*inputs(**kw), 8)
        else:
            dk.check_inputs(*inputs(**kw), 8)
    if bf16:
        with pytest.raises(ValueError, match="shared memory to merge"):
            dk.check_inputs(*inputs(), 4000)
    else:
        with pytest.raises(ValueError, match="accumulators"):
            dk.check_inputs(*inputs(hq=66, hkv=2, d=128), 8)
    q, k, v, pos = inputs()
    with pytest.raises(ValueError, match="int32"):
        dk.check_inputs(q, k, v, pos.long(), 8)
    with pytest.raises(ValueError, match="dtype"):
        dk.check_inputs(q, k.half(), v.half(), pos, 8)
    with pytest.raises(ValueError, match="out of range"):
        dk.check_inputs(q, k, v, pos, 0)
    with pytest.raises(ValueError, match="multiple of hkv"):
        dk.check_inputs(*inputs(hq=3, hkv=2), 8)


def test_flash_routes_by_dtype():
    assert fk.route(torch.bfloat16) == fk.TENSOR_CORES
    assert fk.route(torch.float32) == fk.CUDA_CORES


@pytest.mark.parametrize("arch,hq,hkv,d,tiles", [
    ("internlm2-1.8b", 16, 8, 128, 16), ("zamba2-2.7b", 32, 32, 160, 8),
    ("group of 8", 32, 4, 128, 64)])
def test_flash_tensor_core_geometry_fits_two_blocks_per_sm(arch, hq, hkv, d,
                                                           tiles):
    # 64 packed rows per block over 64-key tiles in a 2-stage ring
    assert fk.TC_ROWS == fk.TC_TILE_TOKENS == 64 and fk.TC_STAGES == 2
    assert fk.tc_blocks_per_sm(d) >= 2, arch
    # packed tiles per kv head at a 511-token prompt: 16 at group 2, so
    # internlm2's 8 kv heads launch 128 blocks on 132 SMs
    assert fk.tc_tiles(511, hq // hkv) == tiles
    # every multiple of 16 up to 256 fits one block
    for dd in range(16, fk.MAX_HEAD_DIM + 1, 16):
        assert fk.tc_smem_bytes(dd) <= fk.MAX_SMEM



@pytest.mark.cuda
def test_ssd_kernel_reruns_are_bit_identical(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(3)
    bh, nc, l, p, n = 24, 2, 256, 64, 128
    x, B, C = (torch.randn(bh, nc, l, d, generator=gen).bfloat16().to(
        cuda_device) for d in (p, n, n))
    dt = (torch.rand(bh, nc, l, generator=gen) * 0.1).to(cuda_device)
    A = -torch.linspace(1.0, 16.0, bh).to(cuda_device)
    first = ssd.ssd_intra_chunk(x, dt, A, B, C)
    for again in ssd.ssd_intra_chunk(x, dt, A, B, C), \
            ssd.ssd_intra_chunk(x, dt, A, B, C):
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_ssd_ablation_substitutions_match_the_kernel_source():
    from repro_torch.benchmarks import ssd_ablation
    src = (ssd_ablation.CSRC / "ssd_scan.cu").read_text()
    for subs in ssd_ablation.ABLATIONS.values():
        for old, _ in subs:
            assert src.count(old) == 1, old


def test_ssd_routes_by_dtype():
    assert ssd.route(torch.bfloat16) == ssd.TENSOR_CORES
    assert ssd.route(torch.float32) == ssd.CUDA_CORES


def test_ssd_shared_memory_mirror_and_block_count():
    # the tensor-core design's layout (ssd_scan.cu tc::smem_bytes): seg,
    # dt and warp totals in f32, C, the B ring and the x ring in bf16 at
    # widths rounded up to 16, plus 8 elements of row padding
    assert ssd.tc_smem_bytes(64, 64) == 2080 + 2 * (3 * 64 * 72
                                                    + 2 * 64 * 72) == 48_160
    assert ssd.tc_smem_bytes(64, 128) == 72_736          # mamba2-130m
    assert ssd.tc_smem_bytes(24, 40) == ssd.tc_smem_bytes(32, 48)
    assert ssd.smem_bytes(torch.bfloat16, 5, 64, 128) == 72_736
    # the f32 design's (ssd_scan.cu smem_bytes_f32) is unchanged
    assert ssd.smem_bytes(torch.float32, 256, 64, 128) == 4 * (
        3 * 256 + 16 * 257 + 272 * 129 + 256 * 65)
    for d in range(8, ssd.MAX_DIM + 1, 8):
        assert ssd.tc_smem_bytes(ssd.MAX_DIM, d) <= ssd.MAX_SMEM
    # per chunk ceil(l / 64) y slabs and ceil(n / 64) state slabs
    assert ssd.num_blocks(torch.bfloat16, 24, 2, 256, 128) == 288
    assert ssd.num_blocks(torch.bfloat16, 640, 1, 256, 64) == 640 * 5
    assert ssd.num_blocks(torch.bfloat16, 640, 1, 64, 64) == 640 * 2
    assert ssd.num_blocks(torch.bfloat16, 24, 1, 5, 128) == 24 * 3
    assert ssd.num_blocks(torch.bfloat16, 7, 3, 100, 40) == 63
    assert ssd.num_blocks(torch.float32, 24, 2, 256, 128) == 48


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_shared_memory_fits_the_served_chunks(dtype):
    # a full 256-row chunk at zamba2-2.7b's (p = n = 64) and mamba2-130m's
    # (p 64, n 128) widths fits one block, in f32 as in bf16
    for p, n in ((64, 64), (64, 128)):
        assert ssd.smem_bytes(dtype, 256, p, n) <= ssd.MAX_SMEM

def test_prefill_routes_by_the_dtype_pair():
    bf16, f32 = torch.bfloat16, torch.float32
    assert pp.route(bf16, bf16) == pp.TENSOR_CORES
    for pair in ((f32, f32), (bf16, torch.int8), (bf16, torch.float8_e4m3fn),
                 (f32, torch.int8), (f32, torch.float8_e4m3fn)):
        assert pp.route(*pair) == pp.CUDA_CORES
    # the CUDA-core design keeps rows x head_dim within its accumulators;
    # the tensor-core one takes TC_ROWS = 64 whatever the chunk
    assert pp.rows_per_tile(64, 2, 128) == 32
    assert pp.rows_per_tile(64, 1, 160) == 25
    assert pp.rows_per_tile(1, 2, 128) == 2


@pytest.mark.parametrize("arch,d,group,c,blocks", [
    ("internlm2-1.8b", 128, 2, 64, 2), ("qwen3-moe-30b-a3b", 128, 8, 64, 8),
    ("zamba2-2.7b", 160, 1, 64, 1)])
def test_tensor_core_prefill_geometry_fits_two_blocks_per_sm(arch, d, group,
                                                             c, blocks):
    # 64 packed rows per block over 64-token tiles in a 2-stage ring
    assert pp.TC_ROWS == pp.TC_TILE_TOKENS == 64 and pp.TC_STAGES == 2
    assert pp.tc_smem_bytes(d) <= pa.MAX_SMEM
    assert pp.tc_blocks_per_sm(d) >= 2, arch
    # blocks per (batch row, kv head) at the served 64-token chunk
    assert -(-c * group // pp.TC_ROWS) == blocks
    # every multiple of 16 up to 256 fits one block
    for dd in range(16, 257, 16):
        assert pp.tc_smem_bytes(dd) <= pa.MAX_SMEM


def test_decode_routes_by_the_dtype_pair_as_prefill_does():
    bf16, f32 = torch.bfloat16, torch.float32
    assert pa.route(bf16, bf16) == pa.TENSOR_CORES
    for pair in ((f32, f32), (bf16, torch.int8), (bf16, torch.float8_e4m3fn),
                 (f32, torch.int8), (f32, torch.float8_e4m3fn)):
        assert pa.route(*pair) == pa.CUDA_CORES
    assert pp.route is pa.route


@pytest.mark.parametrize("d,blocks_per_sm", [(128, 3), (160, 2), (256, 1)])
def test_tensor_core_decode_split_rule_and_shared_memory(d, blocks_per_sm):
    # 128 kv tokens of whole pages per split, at least one page
    assert pa.SPLIT_TOKENS == 128
    assert [pa.split_pages(p) for p in (4, 16, 48, 128, 256)] == [32, 8, 2,
                                                                  1, 1]
    # the main path (b 8, hkv 8, 64 columns of 16 tokens): 8 splits, a
    # grid of 512 blocks, of which those of chip_smoke's positions that
    # walk pages are 248
    assert pa.num_splits(64, 16) == 8
    positions = np.array([1023, 0, 511, 17, 700, 64, 255, 999])
    pages = positions // 16 + 1
    assert 8 * int((-(-pages // pa.split_pages(16))).sum()) == 248
    # blocks resident per SM by shared memory at the served head dims
    assert (pp.SM_SMEM // (pa.tc_smem_bytes(d, 8) + pp.BLOCK_RESERVED_SMEM)
            == blocks_per_sm)
    for dd in range(16, pa.MAX_HEAD_DIM + 1, 16):
        assert pa.tc_smem_bytes(dd, 256) <= pa.MAX_SMEM


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    case = _case(torch.device("cpu"), torch.float32, None, mp=8)
    q = torch.randn(4, case["hq"], case["d"])
    args = (q, case["k"], case["v"], case["bt"],
            torch.clamp(case["positions"], max=127))
    before = (pa.launches, pp.launches)
    torch.testing.assert_close(pa.paged_decode_attention(*args),
                               pa.paged_decode_attention_plain(*args),
                               rtol=0, atol=0)
    start, clen = _chunk(case, 5, "cpu")
    qc = torch.randn(4, 5, case["hq"], case["d"])
    pargs = (qc, case["k"], case["v"], case["bt"], start, clen)
    torch.testing.assert_close(pp.paged_prefill_attention(*pargs),
                               pp.paged_prefill_attention_plain(*pargs),
                               rtol=0, atol=0)
    assert (pa.launches, pp.launches) == before


@pytest.mark.parametrize("row, col", [(0, 30), (2, 0), (3, 40)])
def test_tolerance_takes_the_kernels_rounding_and_refuses_a_page_read_twice(
        row, col):
    # main-path geometry in bf16, on the CPU.  The kernel's arithmetic (p
    # kept in f32, the output rounded to bf16 once) is the plain
    # version's f32 carry, normalised and rounded
    case = _case(torch.device("cpu"), torch.bfloat16, None)
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((4, case["hq"], case["d"]),
                                             dtype=np.float32)).bfloat16()
    kv = (case["k"], case["v"])
    want = pa.paged_decode_attention_plain(q, *kv, case["bt"],
                                           case["positions"])
    _, l, acc = pa.paged_decode_attention_plain(q, *kv, case["bt"],
                                                case["positions"],
                                                partials=True)
    like = (acc / torch.clamp(l, min=1e-30)[..., None]).bfloat16()
    tol = TOLERANCE[torch.bfloat16]
    assert worst_ratio(like, want, *tol)[1] <= 1.0
    bad = case["bt"].clone()
    bad[row, col] = bad[row, col + 1]
    got = pa.paged_decode_attention_plain(q, *kv, bad, case["positions"])
    assert worst_ratio(got, want, *tol)[1] > 4.0


def test_cpu_tensors_take_the_grouped_and_ssd_plain_versions():
    x, w, rows = _grouped_case(torch.device("cpu"), torch.float32, 4, 24, 16,
                               8, True)
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
           for s in ((3, 2, 8, 8), (3, 2, 8), (3,), (3, 2, 8, 16),
                     (3, 2, 8, 16))]
    ins[1], ins[2] = ins[1].abs() * 0.1, -ins[2].abs()
    before = (gm.launches, ssd.launches)
    torch.testing.assert_close(gm.grouped_matmul(x, w, rows),
                               gm.grouped_matmul_plain(x, w, rows),
                               rtol=0, atol=0)
    for a, b in zip(ssd.ssd_intra_chunk(*ins), ssd.ssd_intra_chunk_plain(*ins)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (gm.launches, ssd.launches) == before


class OtherDevice:
    """A tensor's stand-in on a device the wrappers neither launch on nor
    take the plain version on.  ("meta" no longer serves: a meta tensor
    takes the plain version, as the dry-run's traces run on it,
    `kernels/build.py` `plain_device`.)"""
    device = torch.device("xpu")
    requires_grad = False
    dtype = torch.float32

    def __init__(self, *shape):
        self.shape = shape


def test_other_devices_are_refused():
    q = OtherDevice(2, 4, 16)
    kv = OtherDevice(3, 4, 2, 16)
    idx, pos = OtherDevice(2, 2), OtherDevice(2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_decode_attention(q, kv, kv, idx, pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pp.paged_prefill_attention(OtherDevice(2, 1, 4, 16), kv, kv, idx,
                                   pos, pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gm.grouped_matmul(kv, kv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd.ssd_intra_chunk(kv, q, pos, kv, kv)


def test_build_names_the_library_by_its_sources_inside_the_repo():
    root = build.CSRC.parents[3]
    assert build.build_dir() == root / "build" / "repro_torch_kernels"
    assert build.source_digest() == build.source_digest()
    assert len(build.source_digest()) == 16
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


@pytest.mark.cuda
def test_card_streams_do_not_follow_their_batch_mates(cuda_device):
    """On the card every prefill chunk has one width (the engine's one
    bucket), so a request's bf16 K/V and tokens do not depend on the
    chunk widths of the rows it was batched with: cuBLAS picks a GEMM by
    its shape, and at internlm2-1.8b's (8192, 2048) down projection the
    rows of an M 64 product differ from the same rows of an M 512 one.
    The second layer's K/V of a 16-token prompt hold layer 0's down
    projection."""
    from repro_torch.models import registry
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = ModelConfig(name="card-dense", family="dense", num_layers=2,
                      d_model=2048, vocab_size=1024, num_heads=16,
                      num_kv_heads=8, head_dim=128, d_ff=8192,
                      attn_chunk=64, max_seq=256, dtype="bfloat16",
                      param_dtype="bfloat16")
    params = registry.get_family(cfg).init(0, cfg, cuda_device)
    rng = np.random.default_rng(5)
    long = rng.integers(1, cfg.vocab_size, 100).astype(np.int32)
    short = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)

    def serve(prompts, uid):
        """The first page of `uid`'s prompt after the first tick, and
        its tokens."""
        eng = ServingEngine(cfg, params, device=cuda_device, max_batch=8,
                            max_seq=256, page_size=16)
        assert eng.prefill_buckets == [eng.prefill_chunk]
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
        eng.step()
        slot = next(s for s in eng.slots.values() if s.request.uid == uid)
        page = eng.arena.read_pages(slot.pages.pages[:1])
        return page, {r.uid: r.tokens for r in eng.run()}[uid]

    page, tokens = serve([short], 0)
    for prompts, uid in (([short, long], 0), ([long, long[:40], short], 2)):
        got_page, got_tokens = serve(prompts, uid)
        for name, leaf in page.items():
            assert torch.equal(got_page[name], leaf), name
        assert got_tokens == tokens


def test_the_library_is_built_once_under_concurrent_first_calls(
        monkeypatch):
    """`build.library()` is locked: the network front's engine thread and
    a caller's thread may reach the first launch together.  Sixteen
    threads, a short switch interval, one (slow) build."""
    import sys
    import threading
    import time

    made = []

    class SlowLibrary:
        def __init__(self):
            time.sleep(0.01)
            made.append(self)

    monkeypatch.setattr(build, "_library", None)
    monkeypatch.setattr(build, "KernelLibrary", SlowLibrary)
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(
            build.library())) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 1 and len(got) == 16
    assert all(lib is made[0] for lib in got)
