"""Mamba-2 SSD intra-chunk dual form: the Hopper kernel's wrapper and its
plain PyTorch version.

Port of `repro.kernels.ssd_scan` (TPU kernel `ssd_intra_chunk_pallas`,
kernel.py:55).  Per (batch*head, chunk), with seg the inclusive cumsum
of dt * A over the chunk:

    y_intra[i] = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
    s_chunk    = sum_j exp(seg_last - seg_j) dt_j B_j x_j^T   (n, p)
    cdecay     = exp(seg_last)

* `ssd_intra_chunk` — a CUDA tensor launches the hand-written kernel
  (`kernels/csrc/ssd_scan.cu`) or raises; a CPU tensor takes the plain
  version.  `launches` counts kernel launches.
* `ssd_intra_chunk_plain` — the TPU kernel's arithmetic (`_ssd_kernel`,
  kernel.py:27-52) in batched torch: the C.B products in f32, the
  scores rounded to x's dtype before their product with x, the decay
  weight rounded to x's dtype and its product with x rounded again, f32
  outputs.  In f32 it is the intra-chunk branch of `ssd_chunked`
  (models/mamba2.py, "xla").
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run)
launches = 0

# element-type codes of the C interface (csrc/ssd_scan.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (rtol, atol relative to the row's largest |plain|) by x's dtype
# (kernels/tolerance.py's rule).  f32: the same sums in another order
# and the card's expf.  bf16: a score that differs in its last f32 bit
# can round to the neighbouring bf16 value (2**-8 relative), which moves
# an output by that much of one term.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}

# kernel geometry limits (csrc/ssd_scan.cu)
MAX_CHUNK = 256
MAX_DIM = 128
TILE_ROWS = 16
MAX_SMEM = 232_448


def ssd_intra_chunk_plain(x, dt, A, B, C):
    """x: (bh, nc, l, p); dt: (bh, nc, l) f32; A: (bh,) f32; B, C:
    (bh, nc, l, n).  Returns (y_intra (bh, nc, l, p), s_chunk
    (bh, nc, n, p), chunk_decay (bh, nc)), all f32."""
    dtf = dt.float()
    seg = torch.cumsum(dtf * A.float()[:, None, None], dim=2)      # (bh,nc,l)
    l = x.shape[2]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    dlog = torch.where(mask, seg[..., :, None] - seg[..., None, :],
                       torch.full((), NEG_INF, device=x.device))
    cb = torch.einsum("bcln,bcmn->bclm", C.float(), B.float())
    scores = cb * torch.exp(dlog) * dtf[..., None, :]
    y = torch.einsum("bclm,bcmp->bclp", scores.to(x.dtype).float(), x.float())
    w = torch.exp(seg[..., -1:] - seg) * dtf                       # (bh,nc,l)
    wx = w.to(x.dtype)[..., None] * x
    s = torch.einsum("bcln,bclp->bcnp", B.float(), wx.float())
    return y, s, torch.exp(seg[..., -1])


def smem_bytes(dtype, l: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block (ssd_scan.cu smem_bytes)."""
    size = torch.empty((), dtype=dtype).element_size()
    pad = 1 if size == 4 else 2
    return (4 * (3 * l + TILE_ROWS * (l + 1))
            + size * l * (2 * (n + pad) + (p + pad)))


def _launch(x, dt, A, B_, C):
    global launches
    if x.dtype not in DTYPE_CODES or B_.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must share float32 or bfloat16, got "
                         f"{x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("dt and A must be float32")
    bh, nc, l, p = x.shape
    n = B_.shape[-1]
    if (tuple(dt.shape) != (bh, nc, l) or tuple(A.shape) != (bh,)
            or tuple(B_.shape) != (bh, nc, l, n)
            or tuple(C.shape) != (bh, nc, l, n)):
        raise ValueError("want x (bh, nc, l, p), dt (bh, nc, l), A (bh,), "
                         "B and C (bh, nc, l, n)")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B_), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= l <= MAX_CHUNK or p % 8 or n % 8 or not 8 <= p <= MAX_DIM \
            or not 8 <= n <= MAX_DIM:
        raise ValueError(f"chunk {l}, head dim {p}, state {n}: the kernel "
                         f"takes l <= {MAX_CHUNK} and p, n multiples of 8 "
                         f"up to {MAX_DIM}")
    if smem_bytes(x.dtype, l, p, n) > MAX_SMEM:
        raise ValueError(f"chunk {l} x ({p}, {n}) in {x.dtype} needs more "
                         f"shared memory than a block has")
    if bh * nc > 2 ** 31 - 1:
        raise ValueError("too many (batch*head, chunk) blocks")
    dev = x.device
    y = torch.empty((bh, nc, l, p), dtype=torch.float32, device=dev)
    s = torch.empty((bh, nc, n, p), dtype=torch.float32, device=dev)
    cd = torch.empty((bh, nc), dtype=torch.float32, device=dev)
    lib = build.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssd_intra_chunk(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), y.data_ptr(), s.data_ptr(), cd.data_ptr(),
            bh, nc, l, p, n, DTYPE_CODES[x.dtype], stream)
    build.check(err, "ssd_intra_chunk")
    launches += 1
    return y, s, cd


def ssd_intra_chunk(x, dt, A, B, C):
    """x: (bh, nc, l, p); dt: (bh, nc, l) f32; A: (bh,) f32; B, C:
    (bh, nc, l, n), x's dtype (float32 or bfloat16).  Returns (y_intra
    (bh, nc, l, p), s_chunk (bh, nc, n, p), chunk_decay (bh, nc)) f32."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, dt, A, B, C)
