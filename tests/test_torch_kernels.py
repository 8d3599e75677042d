"""The port's CUDA paged-attention kernels against their plain PyTorch
versions, and the wrappers' routing.

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
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
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


def test_other_devices_are_refused():
    q = torch.empty(2, 4, 16, device="meta")
    kv = torch.empty(3, 4, 2, 16, device="meta")
    idx = torch.empty(2, 2, dtype=torch.int32, device="meta")
    pos = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_decode_attention(q, kv, kv, idx, pos)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pp.paged_prefill_attention(q[:, None], kv, kv, idx, pos, pos)


def test_build_names_the_library_by_its_sources_inside_the_repo():
    root = build.CSRC.parents[3]
    assert build.build_dir() == root / "build" / "repro_torch_kernels"
    assert build.source_digest() == build.source_digest()
    assert len(build.source_digest()) == 16
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
