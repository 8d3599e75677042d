"""The port's CUDA kernels (paged decode and prefill attention, grouped
matmul, SSD intra-chunk) against their plain PyTorch versions, and the
wrappers' routing.

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
from repro_torch.kernels.grouped_matmul import ops as gm
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.tolerance import TOLERANCE, worst_ratio

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


def _grouped_case(dev, dtype, E, C, K, F, live):
    """x with only its first rows[e] rows nonzero (the dropless buffer),
    w, and rows; `live` False leaves rows None."""
    rng = np.random.default_rng(E + C + K)
    x = torch.from_numpy(rng.standard_normal((E, C, K), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((E, K, F), dtype=np.float32)
                         * 0.05)
    rows = None
    if live:
        r = rng.integers(0, max(2, C // 16), E).astype(np.int32)
        r[::3] = 0
        r[1] = C                                  # one expert full
        x = x * torch.from_numpy(np.arange(C)[None, :, None]
                                 < r[:, None, None])
        rows = torch.from_numpy(r).to(dev)
    return x.to(dtype).to(dev), w.to(dtype).to(dev), rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E, C, K, F, live", [
    (128, 64, 2048, 768, True),         # qwen3 decode, gate/up
    (128, 64, 768, 2048, True),         # qwen3 decode, down
    (16, 300, 256, 192, False),
    (3, 37, 19, 45, True)])             # ragged C, K, F: masked edges
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
@pytest.mark.parametrize("bh, nc, l, p, n", [(640, 1, 64, 64, 64),
                                             (160, 1, 256, 64, 64),
                                             (6, 3, 13, 16, 24),
                                             (4, 2, 128, 128, 128)])
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


# ------------------------------------------------------ routing (CPU)

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


def test_other_devices_are_refused():
    q = torch.empty(2, 4, 16, device="meta")
    kv = torch.empty(3, 4, 2, 16, device="meta")
    idx = torch.empty(2, 2, dtype=torch.int32, device="meta")
    pos = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_decode_attention(q, kv, kv, idx, pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pp.paged_prefill_attention(q[:, None], kv, kv, idx, pos, pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gm.grouped_matmul(kv, kv.transpose(1, 2))
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
