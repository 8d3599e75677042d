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
  kernel's.

`rows` ((E,) int32, optional) is the number of live rows of each expert
(the dropless dispatch's per-expert counts).  Rows at or past `rows[e]`
come out as zeros and the kernel never reads them (a row range with no
live row reads neither x nor w): in the dropless buffer those rows are
exact zeros, so the output is the same function.  Without `rows` every
row is computed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B

# kernel launches since import (reset by callers that count a run)
launches = 0

# element-type codes of the C interface (csrc/grouped_matmul.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel geometry (csrc/grouped_matmul.cu): a block's row range and n
# tile, and the bf16 ring's slice depth, stages and row padding
ROWS, BN = 64, 64
KS, STAGES, PAD = 32, 4, 8
SM_SMEM = 233_472             # an SM's shared memory, shared by its blocks ...
BLOCK_SMEM_RESERVED = 1_024   # ... each of which also takes this much
MIN_BLOCKS = 5                # __launch_bounds__ of the bf16 kernel (kMinBlocks)

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


def _launch(x, w, rows):
    global launches
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
    return out


def grouped_matmul(x, w, rows=None):
    """x: (E, C, K) @ w: (E, K, F), float32 or bfloat16 (one dtype) ->
    (E, C, F) float32; `rows` (E,) int32 live rows per expert (rows past
    it are zeros)."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, rows)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")
    return _launch(x, w, rows)
