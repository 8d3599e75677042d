"""The kernels at the geometries of the sharded step's layouts, on the
card: the flash forward (with its log-sum-exp) and backward (rows 4,
4b) as one rank of a sequence-parallel step runs them (its block of
queries at q_offset r S / m over the K/V of positions [0, (r + 1) S / m),
GQA), and the SSD intra-chunk kernel and its backward (rows 6, 6b) on
one rank's share of the Mamba heads, each against its plain version per
element (`kernels/tolerance.py`: the backward with `grad_floor`, the
SSD with its ops.py tolerances), bf16 and f32.  Every test needs a CUDA
card and skips without one; this file imports neither JAX nor the
reference:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_seq_parallel_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fk
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.tolerance import TOLERANCE, grad_floor, worst_ratio

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hold(got, want, tol, floor=None):
    for g, w in zip(got, want):
        _, ratio = worst_ratio(g, w, *tol, floor=floor)
        assert ratio <= 1.0, ratio


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_flash_forward_and_backward_at_a_rank_s_block(cuda_device, rank,
                                                      dtype):
    """A rank's 128 queries of a 512-position sequence cut over 4 ranks
    (8 heads over 2 kv heads of 64): keys [0, (rank + 1) 128)."""
    g = torch.Generator(device=cuda_device).manual_seed(rank)
    b, sq, hq, hkv, d = 2, 128, 8, 2, 64
    off, skv = rank * sq, (rank + 1) * sq

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    q, k, v, do = (rnd(b, sq, hq, d), rnd(b, skv, hkv, d),
                   rnd(b, skv, hkv, d), rnd(b, sq, hq, d))
    kw = dict(causal=True, q_offset=off)
    o, lse = fk.flash_attention_lse(q, k, v, **kw)
    po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
    _hold((o,), (po,), TOLERANCE[dtype])
    _hold((lse,), (plse,), TOLERANCE[torch.float32])
    got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = fk.flash_attention_backward_plain(q, k, v, po, do, plse, **kw)
    _hold(got, want, TOLERANCE[dtype], floor=grad_floor)
    # through the autograd Function the sharded step calls
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fk.FlashAttentionFn.apply(qg, kg, vg, True, off)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    _hold(grads, want, TOLERANCE[dtype], floor=grad_floor)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_and_its_backward_on_a_rank_s_heads(cuda_device, dtype):
    """One rank's 6 of 24 heads (p 64, n 128) for 2 rows: bh 12, two
    chunks of 64."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    bh, nc, l, p, n, heads = 12, 2, 64, 64, 128, 6

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale
    args = (rnd(bh, nc, l, p).to(dtype),
            torch.rand(bh, nc, l, generator=g, device=cuda_device) * 0.1,
            (-torch.linspace(1.0, 16.0, heads, device=cuda_device)).repeat(
                bh // heads),
            rnd(bh, nc, l, n, scale=0.3).to(dtype),
            rnd(bh, nc, l, n, scale=0.3).to(dtype))
    _hold(ssd.ssd_intra_chunk(*args), ssd.ssd_intra_chunk_plain(*args),
          ssd.TOLERANCE[dtype])
    dy, ds = rnd(bh, nc, l, p), rnd(bh, nc, n, p)
    _hold(ssd.ssd_intra_chunk_backward(*args, dy, ds),
          ssd.ssd_intra_chunk_backward_plain(*args, dy, ds),
          ssd.BWD_TOLERANCE)
