"""Grouped (per-expert) matmul: the Hopper kernel's wrapper and its
plain PyTorch version.

Port of `repro.kernels.grouped_matmul` (TPU kernel
`grouped_matmul_pallas`, kernel.py:36): x (E, C, K) @ w (E, K, F) ->
(E, C, F) f32 for every expert, the MoE expert stack's product.

* `grouped_matmul` — a CUDA tensor launches the hand-written kernel
  (`kernels/csrc/grouped_matmul.cu`: bf16 on tensor cores over the live
  m16 tiles of each (expert, n tile, row range) block, a 4-stage
  `cp.async` ring of weight slices; f32 on CUDA cores) or raises on a
  device, dtype, shape or layout it does not take; a CPU tensor takes
  the plain version.  `launches` counts kernel launches.
* `grouped_matmul_plain` — `einsum("eck,ekf->ecf")` in f32 (the
  reference oracle `ref.grouped_matmul_ref`), with the rows past
  `rows[e]` zeroed.
* `grid`, `smem_bytes`, `blocks_per_sm` — the launch's blocks, the bf16
  kernel's shared memory and the blocks that share an SM, as the kernel
  computes them; `launched_blocks_per_sm` asks the card for the bf16
  kernel's.  The backward's twins: `bwd_grid`, `bwd_work_items`,
  `bwd_block_items`, `bwd_item_steps`, `bwd_smem_bytes`,
  `bwd_blocks_per_sm`, `launched_bwd_blocks_per_sm`.
* Training: `grouped_matmul` is forward only and raises when grad is
  enabled and x or w requires grad (its result would carry no
  gradient).  `GroupedMatmulFn` (a `torch.autograd.Function`) runs the
  same forward and saves x, w and rows; its backward is
  `grouped_matmul_backward`: dx = dy w^T and dw = x^T dy over each
  expert's live rows (dx zero past them, no gradient for rows), the
  kernels of `kernels/csrc/grouped_matmul_bwd.cu` on a CUDA tensor
  (`BACKWARD.launches` counts calls; bf16 launches three passes: dy's
  live rows rounded to bf16 once into a scratch, then dX and dW on
  wgmma, each a persistent grid, `bwd_grid`, whose blocks walk the
  work items of `bwd_work_items`; f32 launches dX then dW) and
  `grouped_matmul_backward_plain` on a CPU one.  The reference has
  no backward kernel (it differentiates its einsum twin).  dy arrives
  in f32; the bf16 kernels round it to bf16 once (`round_dy_plain` is
  that pass's plain version), and the plain version rounds it at the
  same place: the gradient the einsum twin's autograd sees, whose dy is
  bf16.  They store dx and dw in bf16, the f32 sums rounded once (the
  gradients' own dtype, so autograd casts nothing); the plain version
  returns the f32 sums, and a kernel's bf16 result is held to them by
  TOLERANCE plus that one rounding (`bf16_rounding`).  f32 operands
  give f32 gradients.  `backward_pass_timer` launches the passes one by
  one, for timing them apart.

`rows` ((E,) int32, optional) is the number of live rows of each expert
(the dropless dispatch's per-expert counts).  Rows at or past `rows[e]`
come out as zeros and the kernel never reads them (a row range with no
live row reads neither x nor w): in the dropless buffer those rows are
exact zeros, so the output is the same function.  Without `rows` every
row is computed.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace

# kernel launches since import (reset by callers that count a run): the
# forward's, and the backward's (one per call of its two kernels)
launches = 0
BACKWARD = SimpleNamespace(launches=0)

# element-type codes of the C interface (csrc/grouped_matmul.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel geometry (csrc/grouped_matmul.cu): a block's row range and n
# tile, and the bf16 ring's slice depth, stages and row padding
ROWS, BN = 64, 64
KS, STAGES, PAD = 32, 4, 8
SM_SMEM = 233_472             # an SM's shared memory, shared by its blocks ...
BLOCK_SMEM_RESERVED = 1_024   # ... each of which also takes this much
MIN_BLOCKS = 5                # __launch_bounds__ of the bf16 kernel (kMinBlocks)

# the bf16 backward's design (csrc/grouped_matmul_bwd.cu, namespace wg):
# 384-thread blocks (two consumer warpgroups and a producer), items of
# BWD_TILE_M output rows (64 a consumer) x BWD_TILE_N columns, 64-deep
# ring steps through BWD_STAGES stages
BWD_THREADS, BWD_TILE_M, BWD_TILE_N = 384, 128, 256
BWD_STEP, BWD_STAGES = 64, 4
# the passes of one backward call, bits of the C entry point's `passes`
# (grouped_matmul_bwd.cu `Pass`): dy rounded (bf16 only), dX, dW
BWD_PASSES = {"round": 1, "dx": 2, "dw": 4}
BWD_ALL_PASSES = sum(BWD_PASSES.values())

# (rtol, atol relative to the row's largest |plain|) by input dtype
# (kernels/tolerance.py's rule).  Both versions sum the same exact
# products in f32, in another order; the tensor cores (bf16) also round
# inside each 16-deep step, hence the looser bf16 pair.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-3)}


def _live_mask(rows, E: int, C: int, device):
    return (torch.arange(C, device=device)[None, :]
            < rows.to(device).long()[:, None]).reshape(E, C, 1)


def grouped_matmul_plain(x, w, rows=None):
    """x: (E, C, K) @ w: (E, K, F) -> (E, C, F) f32; rows past
    `rows[e]` are zeros."""
    out = torch.einsum("eck,ekf->ecf", x.float(), w.float())
    if rows is not None:
        E, C = x.shape[:2]
        out = torch.where(_live_mask(rows, E, C, x.device), out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def grouped_matmul_backward_plain(x, w, dy, rows=None):
    """(dx (E, C, K), dw (E, K, F)), f32, of `grouped_matmul_plain` at
    x, w for the output gradient dy (E, C, F): dx = dy w^T on the live
    rows (zeros past `rows[e]`), dw = x^T dy over them.  dy is rounded
    to x's dtype first (the bf16 kernels' tensor cores take bf16)."""
    dy = dy.to(x.dtype).float()
    if rows is not None:
        E, C = x.shape[:2]
        dy = torch.where(_live_mask(rows, E, C, x.device), dy,
                         torch.zeros((), dtype=dy.dtype, device=dy.device))
    dx = torch.einsum("ecf,ekf->eck", dy, w.float())
    dw = torch.einsum("eck,ecf->ekf", x.float(), dy)
    return dx, dw


def round_dy_plain(dy, rows=None, dtype=torch.bfloat16):
    """The rounding pass's plain version: dy (E, C, F) f32 in `dtype`
    (round to nearest even), rows past `rows[e]` zeros (the kernel reads
    no dy there and writes the zeros that its TMA boxes reach: up to the
    next multiple of 64 rows)."""
    out = dy.to(dtype)
    if rows is not None:
        E, C = dy.shape[:2]
        out = torch.where(_live_mask(rows, E, C, dy.device), out,
                          torch.zeros((), dtype=dtype, device=dy.device))
    return out


def bf16_rounding(w):
    """The one rounding of the bf16 backward's stores, as a floor for
    `tolerance.worst_ratio`: half a bf16 ulp (at most 2**-8 of the
    value) of the kernel's f32 sum, which lies within TOLERANCE's bound
    of the plain version's f32 sum w."""
    rtol, atol = TOLERANCE[torch.bfloat16]
    a = w.abs()
    return 2.0 ** -8 * ((1 + rtol) * a + atol * a.amax(-1, keepdim=True))


def grid(E: int, C: int, F: int) -> tuple[int, int, int]:
    """The launch's blocks: (n tiles, experts, row ranges)."""
    return -(-F // BN), E, -(-C // ROWS)


def smem_bytes() -> int:
    """Shared memory of one bf16 block: STAGES x (an x slice of ROWS x
    (KS + PAD) and a w slice of KS x (BN + PAD)) bf16."""
    return STAGES * (ROWS * (KS + PAD) + KS * (BN + PAD)) * 2


def blocks_per_sm() -> int:
    """bf16 blocks that share an SM: as many as its shared memory holds,
    at most MIN_BLOCKS (the registers they are bounded to)."""
    return min(MIN_BLOCKS, SM_SMEM // (smem_bytes() + BLOCK_SMEM_RESERVED))


def launched_blocks_per_sm(vec: bool = True, device=None) -> int:
    """Blocks per SM of the bf16 kernel a call launches (`vec`: the
    instance with 16-byte copies, else element copies), from the card's
    occupancy API."""
    lib = B.library().lib
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.repro_grouped_blocks_per_sm(int(vec), ctypes.byref(blocks))
    B.check(err, "grouped_blocks_per_sm")
    return blocks.value


def bwd_work_items(kind: str, E: int, C: int, K: int, F: int) -> list:
    """The bf16 backward's work items in the kernel's order, expert-major
    (grouped_matmul_bwd.cu `wg::item_of`): "dx" (expert, first row, first
    k column), row ranges fastest; "dw" (expert, first k row, first f
    column), f tiles fastest."""
    tm, tn = BWD_TILE_M, BWD_TILE_N
    if kind == "dx":
        return [(e, r, k) for e in range(E) for k in range(0, K, tn)
                for r in range(0, C, tm)]
    return [(e, k, f) for e in range(E) for k in range(0, K, tm)
            for f in range(0, F, tn)]


def bwd_item_steps(kind: str, item: tuple, live: int, F: int) -> int:
    """Ring steps of one item (`wg::item_of`): dX walks F when its rows
    hold a live one, else none (it stores zeros); dW walks the expert's
    live rows."""
    if kind == "dx":
        return -(-F // BWD_STEP) if item[1] < live else 0
    return -(-live // BWD_STEP)


def bwd_grid(E: int, C: int, K: int, F: int, sms: int) -> dict:
    """Blocks of the persistent bf16 dX and dW launches: one an SM, at
    most one an item (grouped_matmul_bwd.cu `wg::launch`)."""
    return {kind: min(len(bwd_work_items(kind, E, C, K, F)), sms)
            for kind in ("dx", "dw")}


def bwd_block_items(kind: str, E: int, C: int, K: int, F: int,
                    sms: int) -> list:
    """The items each block of a persistent launch walks, in its order:
    block b takes items b, b + blocks, b + 2 blocks, ..."""
    items = bwd_work_items(kind, E, C, K, F)
    blocks = bwd_grid(E, C, K, F, sms)[kind]
    return [items[b::blocks] for b in range(blocks)]


def bwd_smem_bytes() -> int:
    """Dynamic shared memory of one bf16 dX or dW block
    (grouped_matmul_bwd.cu `wg::kSmemBytes`): 1024 bytes to align the
    panels, BWD_STAGES stages of a 128 x 64 and a 256 x 64 bf16 operand,
    and the ring's 2 x BWD_STAGES mbarriers."""
    stage = 2 * BWD_STEP * (BWD_TILE_M + BWD_TILE_N)
    return 1024 + BWD_STAGES * stage + 2 * BWD_STAGES * 8


def bwd_blocks_per_sm() -> int:
    """bf16 dX or dW blocks that share an SM: as many as its shared
    memory holds (the registers of 384 threads allow one)."""
    return min(1, SM_SMEM // (bwd_smem_bytes() + BLOCK_SMEM_RESERVED))


def launched_bwd_blocks_per_sm(kind: str, device=None) -> int:
    """Blocks per SM of the bf16 backward's "dx" or "dw" kernel, from the
    card's occupancy API."""
    lib = B.library().lib
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.repro_grouped_bwd_blocks_per_sm(
            0 if kind == "dx" else 1, ctypes.byref(blocks))
    B.check(err, "grouped_bwd_blocks_per_sm")
    return blocks.value


_SMS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check(x, w, rows):
    """(E, C, K, F) of x (E, C, K) @ w (E, K, F); raises on what the
    kernels do not take."""
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul takes float32 or bfloat16 x and w "
                         f"of one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}: want "
                         f"(E, C, K) @ (E, K, F)")
    E, C, K = x.shape
    F = w.shape[2]
    named = {"x": x, "w": w}
    if rows is not None:
        named["rows"] = rows
        if rows.dtype != torch.int32 or tuple(rows.shape) != (E,):
            raise ValueError(f"rows must be int32 ({E},)")
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(E, C, K, F) < 1 or max(grid(E, C, F)[1:]) > 65535:
        raise ValueError(f"grid of E {E} x C {C} out of range")
    return E, C, K, F


def _launch(x, w, rows):
    global launches
    E, C, K, F = _check(x, w, rows)
    vec = int(K % 8 == 0 and F % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    out = torch.empty((E, C, F), dtype=torch.float32, device=x.device)
    lib = B.library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), E, C, K, F,
            DTYPE_CODES[x.dtype], vec, stream)
    B.check(err, "grouped_matmul")
    launches += 1
    _report(x, w, rows, out)
    return out


def _live_rows(x, rows) -> int:
    E, C = x.shape[:2]
    return E * C if rows is None else int(rows.long().sum())


@_trace.reporter
def _report(x, w, rows, out):
    """A forward launch's work to the active traces: 2 K F FLOPs per
    live row, the live rows of x and the weights of the experts with a
    live row read once, the whole output written."""
    E, C, K = x.shape
    F = w.shape[2]
    el = x.element_size()
    live_e = E if rows is None else int((rows > 0).sum())
    _trace.kernel("grouped_matmul", flops=2 * _live_rows(x, rows) * K * F,
                  bytes_read=el * (_live_rows(x, rows) * K + live_e * K * F),
                  bytes_written=_trace.tensors_bytes(out), outputs=(out,))


@_trace.reporter
def _report_bwd(x, w, rows, dx, dw):
    """A backward launch's work: dX = dY w^T and dW = x^T dY over the
    live rows (4 K F FLOPs a row), x's live rows, w and dY's live rows
    read, dx and dw written."""
    E, C, K = x.shape
    F = w.shape[2]
    n, el = _live_rows(x, rows), x.element_size()
    _trace.kernel("grouped_matmul_backward", flops=4 * n * K * F,
                  bytes_read=el * (n * K + E * K * F) + 4 * n * F,
                  bytes_written=_trace.tensors_bytes(dx, dw),
                  outputs=(dx, dw))


def _bwd_buffers(x, w) -> dict:
    """The backward's outputs and scratch: dx, dw in x's dtype and (bf16)
    dy's rounded rows, (E, C, F) bf16."""
    E, C, K = x.shape
    F = w.shape[2]
    return {"dx": torch.empty((E, C, K), dtype=x.dtype, device=x.device),
            "dw": torch.empty((E, K, F), dtype=x.dtype, device=x.device),
            "dy16": (torch.empty((E, C, F), dtype=torch.bfloat16,
                                 device=x.device)
                     if x.dtype == torch.bfloat16 else None)}


def _launch_bwd(x, w, dy, rows, passes: int = BWD_ALL_PASSES,
                bufs: dict | None = None):
    """The backward kernel's passes named by the bits of `passes` (all by
    default) into `bufs` (`_bwd_buffers`; fresh ones by default), whose
    dx and dw it returns."""
    E, C, K, F = _check(x, w, rows)
    if (dy.dtype != torch.float32 or tuple(dy.shape) != (E, C, F)
            or dy.device != x.device or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous float32 ({E}, {C}, {F}) "
                         f"on {x.device}")
    if x.dtype == torch.bfloat16 and (
            K % 8 or F % 8 or any(t.data_ptr() % 16 for t in (x, w, dy))):
        raise ValueError(f"the bf16 backward takes K ({K}) and F ({F}) "
                         f"multiples of 8 and 16-byte aligned x, w, dy")
    if max(-(-K // 64), -(-C // 64)) > 65535:
        raise ValueError(f"K {K} or C {C} exceeds the grid")
    if bufs is None:
        bufs = _bwd_buffers(x, w)
    dx, dw, dy16 = bufs["dx"], bufs["dw"], bufs["dy16"]
    lib = B.library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_matmul_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            None if dy16 is None else dy16.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), None if rows is None else rows.data_ptr(),
            E, C, K, F, DTYPE_CODES[x.dtype], _sm_count(x.device),
            int(passes), stream)
    B.check(err, "grouped_matmul_backward")
    BACKWARD.launches += 1
    _report_bwd(x, w, rows, dx, dw)
    return dx, dw


def backward_pass_timer(x, w, dy, rows=None) -> dict:
    """For timing the backward kernel's passes apart on the card: runs
    one whole call, then returns {pass name: a callable that launches
    only that pass into the same buffers} ("round" in bf16 only)."""
    bufs = _bwd_buffers(x, w)
    _launch_bwd(x, w, dy, rows, bufs=bufs)
    return {name: (lambda bit=bit: _launch_bwd(x, w, dy, rows, passes=bit,
                                               bufs=bufs))
            for name, bit in BWD_PASSES.items()
            if name != "round" or x.dtype == torch.bfloat16}


def _device(x, what: str) -> str:
    """"cpu" where x takes the plain version (`build.plain_device`),
    "cuda" where it launches the kernel."""
    if B.plain_device(x):
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return "cuda"


def grouped_matmul(x, w, rows=None):
    """x: (E, C, K) @ w: (E, K, F), float32 or bfloat16 (one dtype) ->
    (E, C, F) float32; `rows` (E,) int32 live rows per expert (rows past
    it are zeros).  Forward only: raises when grad is enabled and x or w
    requires grad (use `GroupedMatmulFn`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "grouped_matmul is the forward-only launcher and its result "
            "carries no gradient; differentiate through "
            "GroupedMatmulFn.apply(x, w, rows)")
    return _forward(x, w, rows)


def _forward(x, w, rows):
    if B.plain_device(x):
        return grouped_matmul_plain(x, w, rows)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")
    return _launch(x, w, rows)


def grouped_matmul_backward(x, w, dy, rows=None):
    """(dx, dw) of the grouped matmul at x, w for the output gradient dy
    (E, C, F) f32: the backward kernels on a CUDA tensor (in x's dtype:
    bf16 stores the f32 sums rounded once), `grouped_matmul_backward_plain`
    on a CPU one (f32)."""
    if _device(x, "grouped_matmul_backward") == "cpu":
        return grouped_matmul_backward_plain(x, w, dy, rows)
    return _launch_bwd(x, w, dy, rows)


class GroupedMatmulFn(torch.autograd.Function):
    """Differentiable grouped matmul: the forward kernel and the backward
    kernels on the card (their plain versions on the CPU).
    `GroupedMatmulFn.apply(x, w, rows)` -> (E, C, F) f32; x and w get
    gradients in their own dtypes, `rows` none."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return _forward(x, w, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        dx, dw = grouped_matmul_backward(x, w, dy.float().contiguous(), rows)
        return dx.to(x.dtype), dw.to(w.dtype), None
