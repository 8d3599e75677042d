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
  version.  `launches` counts kernel launches.  The kernel has two
  designs, fixed by x's dtype (`route`); neither falls back to the
  other: bf16, what every served configuration runs, on tensor cores
  (mma.sync; one block per 64-row slab of a chunk's y rows or of its
  state rows, `num_blocks`; B and x through a cp.async ring), f32 on
  CUDA cores (one block per chunk; tensor cores would run it in TF32).
* Training: `ssd_intra_chunk` is forward only and raises when grad is
  enabled and an input requires grad.  `SsdIntraChunkFn` (a
  `torch.autograd.Function`) runs the same forward, saves only the
  inputs and returns (y_intra, s_chunk) (`ssd_chunked` discards the
  chunk decay, which it recomputes from seg); its backward is
  `ssd_intra_chunk_backward`: dx, ddt, dA (bh,), dB and dC, from the
  kernels of `kernels/csrc/ssd_scan_bwd.cu` on a CUDA tensor
  (`BACKWARD.launches` counts calls, each launching a column and a row
  kernel, one block per 64-row slab of a chunk each, `bwd_num_blocks`)
  and from `ssd_intra_chunk_backward_plain` on a CPU one, then d(seg)
  turned into d(dt) by a reverse cumsum in torch.  The backward routes
  by x's dtype as the forward does (`route`), with no fallback between
  the two: bf16, what every SSM and hybrid training step runs, on
  tensor cores (mma.sync, 32-token tiles through a cp.async ring, p
  and n rounded up to an instance width of 16, 32, 64 or 128,
  `bwd_width`), each f32 operand (dy, ds, the scores) fed as a sum of
  bf16 pieces, so nothing is rounded that the plain version does not
  round; f32 on CUDA cores.  dA is summed pair by pair
  with d seg_i / dA = cs_i (the cumsum of dt), whose differences are
  positive, and not as sum_k dt_k revcumsum(dseg)_k, where row and
  column sums of the same terms cancel.  The backward is the
  gradient of the unrounded function in f32 at the inputs as given (for
  bf16 inputs too); the reference has no backward kernel (it
  differentiates its XLA branch).
* `ssd_intra_chunk_plain` — the TPU kernel's arithmetic (`_ssd_kernel`,
  kernel.py:27-52) in batched torch: the C.B products in f32, the
  scores rounded to x's dtype before their product with x, the decay
  weight rounded to x's dtype and its product with x rounded again, f32
  outputs.  In f32 it is the intra-chunk branch of `ssd_chunked`
  (models/mamba2.py, "xla").
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.kernels import build
from repro_torch.launch import trace as _trace

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run): the
# forward's, and the backward's (one per call of its two kernels)
launches = 0
BACKWARD = SimpleNamespace(launches=0)

# element-type codes of the C interface (csrc/ssd_scan.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (rtol, atol relative to the row's largest |plain|) by x's dtype
# (kernels/tolerance.py's rule).  f32: the same sums in another order
# and the card's expf.  bf16: a score that differs in its last f32 bit
# can round to the neighbouring bf16 value (2**-8 relative), which moves
# an output by that much of one term.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# the backward's (rtol, atol relative to the row's largest |plain|), for
# every input dtype: kernel and plain version compute the same f32
# function of the inputs, summed in other orders (tiles, the warp scan
# of seg, the reverse cumsum) and, in bf16, from operands split into
# bf16 pieces (ssd_scan_bwd.cu: each product term within ~3 x 2**-16 of
# its size).  Worst elements measured on an H100 at chip_smoke's
# training chunks: f32 design 0.33 of this bound against the f64
# gradient; bf16 design 0.52 against the plain version and 0.98 against
# f64, at a dC element whose dy . x nearly cancels, where the f32 plain
# version is far from f64 too (chip_smoke's `plain_against_f64`: the f32
# function's own conditioning)
BWD_TOLERANCE = (1e-4, 1e-4)

# kernel geometry limits (csrc/ssd_scan.cu)
MAX_CHUNK = 256
MAX_DIM = 128
TILE_ROWS = 16         # the f32 design's output rows per tile
MAX_SMEM = 232_448

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
# the tensor-core design's geometry (ssd_scan.cu namespace tc)
TC_SLAB = 64           # y rows or state rows per block, 16 per warp
TC_TILE_TOKENS = 64    # tokens per B / x tile
TC_STAGES = 2          # B / x tiles in flight (cp.async ring)
TC_PAD = 8             # bf16 elements of shared-memory row padding


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


def _bwd_terms_plain(x, dt, A, B, C, dy, ds):
    """The backward kernels' results (dx, dB, dC, ddt, dseg, dA (bh,)) in
    f32 (f64 for f64 inputs), with ddt the direct part and dseg the
    gradient through seg before the reverse cumsum (the kernels' dseg_q +
    dseg_k, plus sum_j dww_j at the last position).  dA is summed pair by
    pair with d seg_i / dA = cs_i, the cumsum of dt, as the kernel sums
    it."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, B, C, dy, ds = (t.to(ct) for t in (x, B, C, dy, ds))
    dtf = dt.to(ct)
    seg = torch.cumsum(dtf * A.to(ct)[:, None, None], dim=2)      # (bh,nc,l)
    l = x.shape[2]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    L = torch.where(mask, torch.exp(torch.where(
        mask, seg[..., :, None] - seg[..., None, :],
        torch.zeros((), dtype=ct, device=x.device))),
        torch.zeros((), dtype=ct, device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    scores = cb * L * dtf[..., None, :]
    dsc = torch.einsum("bcip,bcjp->bcij", dy, x) * mask
    dcb = dsc * L * dtf[..., None, :]
    e = torch.exp(seg[..., -1:] - seg)                             # (bh,nc,l)
    w = e * dtf
    bds = torch.einsum("bcjn,bcnp->bcjp", B, ds)                   # B_j . ds
    dsx = torch.einsum("bcnp,bcjp->bcjn", ds, x)                   # ds x_j
    dw = (B * dsx).sum(-1)                                         # (bh,nc,l)
    dx = torch.einsum("bcij,bcip->bcjp", scores, dy) + w[..., None] * bds
    dC = torch.einsum("bcij,bcjn->bcin", dcb, B)
    dB = torch.einsum("bcij,bcin->bcjn", dcb, C) + w[..., None] * dsx
    ddt = (dsc * cb * L).sum(-2) + dw * e
    p_ = dsc * scores
    dww = dw * w
    dseg = p_.sum(-1) - p_.sum(-2) - dww
    dseg[..., -1] += dww.sum(-1)
    cs = torch.cumsum(dtf, dim=2)
    dA = ((p_ * (cs[..., :, None] - cs[..., None, :])).sum((-1, -2))
          + (dww * (cs[..., -1:] - cs)).sum(-1)).sum(-1)
    return dx, dB, dC, ddt, dseg, dA


def _seg_to_dt(dt, A, ddt, dseg):
    """ddt from its direct part and d(seg), seg = cumsum of dt * A over
    each chunk: a reverse cumsum of d(seg)."""
    g = torch.flip(torch.cumsum(torch.flip(dseg, (-1,)), -1), (-1,))
    return ddt + A.to(ddt.dtype)[:, None, None] * g


def ssd_intra_chunk_backward_plain(x, dt, A, B, C, dy, ds):
    """(dx, ddt, dA, dB, dC), f32 (f64 for f64 x), of (y_intra, s_chunk)
    = `ssd_intra_chunk_plain`'s first two outputs (unrounded: the f32
    function) at the inputs, for the output gradients dy (bh, nc, l, p)
    and ds (bh, nc, n, p)."""
    dx, dB, dC, ddt, dseg, dA = _bwd_terms_plain(x, dt, A, B, C, dy, ds)
    return dx, _seg_to_dt(dt, A, ddt, dseg), dA, dB, dC


def route(dtype) -> str:
    """The kernel design x's dtype takes: bf16 the tensor-core one, f32
    the CUDA-core one (ssd_scan.cu `repro_ssd_intra_chunk`)."""
    return TENSOR_CORES if dtype == torch.bfloat16 else CUDA_CORES


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def tc_smem_bytes(p: int, n: int) -> int:
    """Dynamic shared memory of one tensor-core block (ssd_scan.cu
    `tc::smem_bytes`): seg and dt [256] and 8 warp totals in f32, then C
    [64][n16 + 8], the B ring [2][64][n16 + 8] and the x ring
    [2][64][p16 + 8] in bf16 (n16, p16: rounded up to 16)."""
    return (4 * (2 * MAX_CHUNK + 8)
            + 2 * ((1 + TC_STAGES) * TC_SLAB * (_pad16(n) + TC_PAD)
                   + TC_STAGES * TC_TILE_TOKENS * (_pad16(p) + TC_PAD)))


def smem_bytes(dtype, l: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block of the design `dtype` takes
    (ssd_scan.cu `tc::smem_bytes`, `smem_bytes_f32`)."""
    if route(dtype) == TENSOR_CORES:
        return tc_smem_bytes(p, n)
    return 4 * (3 * l + TILE_ROWS * (l + 1) + (l + TILE_ROWS) * (n + 1)
                + l * (p + 1))


def num_blocks(dtype, bh: int, nc: int, l: int, n: int) -> int:
    """Blocks of one launch: per chunk, ceil(l / 64) y slabs and
    ceil(n / 64) state slabs in bf16 (ssd_scan.cu `tc::slabs`), one
    block in f32."""
    if route(dtype) == TENSOR_CORES:
        return bh * nc * (-(-l // TC_SLAB) + -(-n // TC_SLAB))
    return bh * nc


def _check(x, dt, A, B_, C):
    """(bh, nc, l, p, n) of the inputs; raises on what the kernels do
    not take."""
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
    return bh, nc, l, p, n


@_trace.reporter
def _report(x, dt, A, B_, C, outs):
    """A forward launch's work to the active traces: per (batch*head,
    chunk) the scores C B^T and y over the l (l + 1) / 2 causal pairs and
    the chunk state (2 l n p), the inputs read once, the outputs
    written."""
    bh, nc, l, p = x.shape
    n = B_.shape[-1]
    pairs = l * (l + 1) // 2
    _trace.kernel("ssd_intra_chunk",
                  flops=bh * nc * (2 * pairs * (n + p) + 2 * l * n * p),
                  bytes_read=_trace.tensors_bytes(x, dt, A, B_, C),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


@_trace.reporter
def _report_bwd(x, dt, A, B_, C, dy, ds, outs):
    """A backward launch's work: the recomputed scores and their
    gradients over the causal pairs (6 n + 4 p a pair) and the state's
    (4 l n p), per (batch*head, chunk); the inputs and dy, ds read, the
    gradient terms written."""
    bh, nc, l, p = x.shape
    n = B_.shape[-1]
    pairs = l * (l + 1) // 2
    _trace.kernel("ssd_intra_chunk_backward",
                  flops=bh * nc * (pairs * (6 * n + 4 * p) + 4 * l * n * p),
                  bytes_read=_trace.tensors_bytes(x, dt, A, B_, C, dy, ds),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


def _launch(x, dt, A, B_, C):
    global launches
    bh, nc, l, p, n = _check(x, dt, A, B_, C)
    if smem_bytes(x.dtype, l, p, n) > MAX_SMEM:
        raise ValueError(f"chunk {l} x ({p}, {n}) in {x.dtype} needs more "
                         f"shared memory than a block has")
    if num_blocks(x.dtype, bh, nc, l, n) > 2 ** 31 - 1:
        raise ValueError("too many (batch*head, chunk) blocks")
    if route(x.dtype) == TENSOR_CORES and any(
            t.data_ptr() % 16 for t in (x, B_, C)):
        raise ValueError("x, B and C must start on 16-byte boundaries")
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
    _report(x, dt, A, B_, C, (y, s, cd))
    return y, s, cd


# the backward's tensor-core design (ssd_scan_bwd.cu namespace tc)
BWD_TC_TILE = 32       # tokens per walked tile
BWD_SLAB = 64          # rows (columns j or rows i) per block, both designs
BWD_TC_WIDTHS = (16, 32, 64, 128)


def bwd_width(v: int) -> int:
    """p or n rounded up to an instance width of the backward's
    tensor-core kernels (ssd_scan_bwd.cu `tc::width`)."""
    return next(w for w in BWD_TC_WIDTHS if v <= w)


def bwd_smem_bytes(dtype, p: int, n: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the backward's column and
    row kernels in the design `dtype` takes.  bf16 (ssd_scan_bwd.cu
    `tc::col_smem_bytes`, `tc::row_smem_bytes`), at widths pw, nw =
    `bwd_width(p)`, `bwd_width(n)`: the column kernel's seg and cs [256]
    and 8 warp totals in f64, dt [256] and the dy / ds ring [2][32][pw +
    4] in f32, then B [64], the C ring [2][32] at nw + 8, x [64] and three
    pieces [3][32] at pw + 8 in bf16; the row kernel's seg [256] and 8
    warp totals in f64, dt [256] in f32, then C [64] and the B ring
    [2][32] at nw + 8, dy's pieces [3][64] and the x ring [2][32] at pw +
    8 in bf16.  f32 (`k_smem_floats`, `q_smem_floats`)."""
    if route(dtype) == TENSOR_CORES:
        pw, nw = bwd_width(p), bwd_width(n)
        t = BWD_TC_TILE
        return (8 * (2 * MAX_CHUNK + 8) + 4 * (MAX_CHUNK + 2 * t * (pw + 4))
                + 2 * ((BWD_SLAB + 2 * t) * (nw + TC_PAD)
                       + (BWD_SLAB + 3 * t) * (pw + TC_PAD)),
                8 * (MAX_CHUNK + 8) + 4 * MAX_CHUNK
                + 2 * ((BWD_SLAB + 2 * t) * (nw + TC_PAD)
                       + (3 * BWD_SLAB + 2 * t) * (pw + TC_PAD)))
    rows = 96 * (n + 1)
    return (4 * (rows + 128 * (p + 1) + 3 * MAX_CHUNK + 2 * 32 * 65
                 + 3 * 256 + 2 * 64),
            4 * (rows + 96 * (p + 1) + 2 * MAX_CHUNK + 64 * 33 + 256))


def bwd_num_blocks(bh: int, nc: int, l: int) -> int:
    """Blocks of each of the backward's launches, in both designs: one
    per (batch*head, chunk, 64-row slab)."""
    return bh * nc * -(-l // BWD_SLAB)


def bwd_col_splits(dtype, p: int, n: int) -> int:
    """Column-pass launches of one backward call: in bf16, 2 where p's
    and n's widths add up past 192 (p and n past 64), one summing dx and
    the per-column scalars and one dB, so that neither spills
    (ssd_scan_bwd.cu `tc::col_splits`); else 1."""
    if route(dtype) == TENSOR_CORES and bwd_width(p) + bwd_width(n) > 192:
        return 2
    return 1


def _launch_bwd(x, dt, A, B_, C, dy, ds):
    bh, nc, l, p, n = _check(x, dt, A, B_, C)
    for name, t, shape in (("dy", dy, (bh, nc, l, p)),
                           ("ds", ds, (bh, nc, n, p))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"on {x.device}")
    if bwd_num_blocks(bh, nc, l) > 2 ** 31 - 1:
        raise ValueError("too many (batch*head, chunk, slab) blocks")
    if route(x.dtype) == TENSOR_CORES and any(
            t.data_ptr() % 16 for t in (x, B_, C, dy, ds)):
        raise ValueError("x, B, C, dy and ds must start on 16-byte "
                         "boundaries")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((bh, nc, l, p), **f32)
    dB = torch.empty((bh, nc, l, n), **f32)
    dC = torch.empty((bh, nc, l, n), **f32)
    ddt, dseg_q, dseg_k, dww, dA = (torch.empty((bh, nc, l), **f32)
                                    for _ in range(5))
    lib = build.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssd_intra_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ds.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dseg_q.data_ptr(),
            dseg_k.data_ptr(), dww.data_ptr(), dA.data_ptr(), bh, nc, l, p, n,
            DTYPE_CODES[x.dtype], stream)
    build.check(err, "ssd_intra_chunk_backward")
    BACKWARD.launches += 1
    _report_bwd(x, dt, A, B_, C, dy, ds,
                (dx, dB, dC, ddt, dseg_q, dseg_k, dww, dA))
    dseg = dseg_q + dseg_k
    dseg[..., -1] += dww.sum(-1)
    return dx, dB, dC, ddt, dseg, dA.sum((1, 2))


def _device(x, what: str) -> str:
    """"cpu" where x takes the plain version (`build.plain_device`),
    "cuda" where it launches the kernel."""
    if build.plain_device(x):
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return "cuda"


def ssd_intra_chunk_backward(x, dt, A, B, C, dy, ds):
    """(dx, ddt, dA (bh,), dB, dC), f32, of (y_intra, s_chunk) at the
    inputs for the output gradients dy (bh, nc, l, p) and ds (bh, nc, n,
    p), f32: the backward kernels on a CUDA tensor, the plain version's
    terms on a CPU one; then the reverse cumsum of d(seg) in torch and
    dA summed over each batch*head's chunks."""
    if _device(x, "ssd_intra_chunk_backward") == "cpu":
        return ssd_intra_chunk_backward_plain(x, dt, A, B, C, dy, ds)
    dx, dB, dC, ddt, dseg, dA = _launch_bwd(x, dt, A, B, C, dy, ds)
    return dx, _seg_to_dt(dt, A, ddt, dseg), dA, dB, dC


def ssd_intra_chunk(x, dt, A, B, C):
    """x: (bh, nc, l, p); dt: (bh, nc, l) f32; A: (bh,) f32; B, C:
    (bh, nc, l, n), x's dtype (float32 or bfloat16).  Returns (y_intra
    (bh, nc, l, p), s_chunk (bh, nc, n, p), chunk_decay (bh, nc)) f32.
    Forward only: raises when grad is enabled and an input requires grad
    (use `SsdIntraChunkFn`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "ssd_intra_chunk is the forward-only launcher and its result "
            "carries no gradient; differentiate through "
            "SsdIntraChunkFn.apply(x, dt, A, B, C)")
    return _forward(x, dt, A, B, C)


def _forward(x, dt, A, B, C):
    if build.plain_device(x):
        return ssd_intra_chunk_plain(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, dt, A, B, C)


class SsdIntraChunkFn(torch.autograd.Function):
    """Differentiable SSD intra-chunk: the forward kernel and the
    backward kernels on the card (their plain versions on the CPU).
    `SsdIntraChunkFn.apply(x, dt, A, B, C)` -> (y_intra (bh, nc, l, p),
    s_chunk (bh, nc, n, p)), f32; every input gets its gradient in its
    own dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        y, s, _ = _forward(x, dt, A, B, C)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if ds is None:
            ds = torch.zeros((*x.shape[:2], B.shape[-1], x.shape[-1]),
                             dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC = ssd_intra_chunk_backward(
            x, dt, A, B, C, dy.float().contiguous(), ds.float().contiguous())
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dB.to(B.dtype), dC.to(C.dtype))
