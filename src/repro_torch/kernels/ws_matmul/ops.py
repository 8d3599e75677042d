"""Weight-stationary and output-stationary blocked matmul: the Hopper
kernels' wrappers, their plain PyTorch version and the dataflows'
traffic model.

Port of `repro.kernels.ws_matmul` (TPU kernels `ws_matmul_pallas`,
kernel.py:49, and `os_matmul_pallas`, kernel.py:87): x (M, K) @ w (K, N)
-> (M, N) float32, with x and w of one dtype.  The two compute the same
function and differ in which operand stays resident, which is what the
paper's dataflow ablation (`benchmarks/ws_dataflow.py`) is about.

* `ws_matmul`, `os_matmul` — the JAX signature `(x, w, block_m=128,
  block_n=128, block_k=128)`.  A CUDA tensor launches the hand-written
  kernel (`kernels/csrc/ws_matmul.cu`: both dataflows on one
  cp.async-pipelined mainloop, a 3-stage ring of KS-deep slices) or
  raises on a device, dtype, shape or layout it does not take; a CPU
  tensor takes `matmul_plain`.  Both paths refuse what the JAX function
  asserts (a k mismatch, dims not divisible by `min(block, dim)`) and a
  block the kernel cannot hold (`plan`: in bf16 a weight tile deeper
  than 640, in f32 than 320).  `WS.launches` and `OS.launches` count
  kernel launches.
* `matmul_plain` — `torch.matmul` in f32 (the oracle `ref.matmul_ref`).
* `hbm_traffic_model` — the TPU package's analytic byte count of the two
  grid orders, copied verbatim.
* `smem_bytes`, `blocks_per_sm`, `ws_splits` — the kernels' shared
  memory, the blocks that share an SM, and the WS kernel's split of an
  n tile's M tiles, as the launcher computes them;
  `launched_blocks_per_sm` asks the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace

DEF_BM, DEF_BN, DEF_BK = 128, 128, 128

# kernel launches since import (reset by callers that count a run)
WS = SimpleNamespace(launches=0)
OS = SimpleNamespace(launches=0)

# element-type codes of the C interface (csrc/ws_matmul.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel geometry (csrc/ws_matmul.cu Geo / Layout): the largest bm x bn
# a block holds in registers, per dtype the depth KS of one slice, the
# shared row padding and the elements per 16-byte load, and the ring's
# stages
MAX_BM = MAX_BN = 128
GEO = {torch.bfloat16: (64, 8, 8), torch.float32: (32, 4, 4)}
STAGES = 3
MAX_SMEM = 232_448            # a block's dynamic shared memory
SM_SMEM = 233_472             # an SM's, shared by its blocks ...
BLOCK_SMEM_RESERVED = 1_024   # ... each of which also takes this much
MIN_BLOCKS = 2                # __launch_bounds__: registers for two blocks,
MIN_BLOCKS_RMW = 1            # and one for WS's read-modify-write kernel
                              # (kMinBlocks, kMinBlocksRmw)
# the deepest weight tile `plan` lets WS hold, per dtype (smem_bytes of
# the resident tile and the ring within MAX_SMEM, in whole slices)
MAX_BK = {torch.bfloat16: 640, torch.float32: 320}

# (rtol, atol relative to the row's largest |plain|) by input dtype
# (kernels/tolerance.py's rule).  Both versions sum the same exact
# products in f32, in another order; the tensor cores (bf16) also round
# inside each 16-deep step, hence the looser bf16 pair.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-3)}


def matmul_plain(x, w):
    """x: (M, K) @ w: (K, N) -> (M, N) float32."""
    return torch.matmul(x.float(), w.float())


def hbm_traffic_model(m, n, k, bm=DEF_BM, bn=DEF_BN, bk=DEF_BK, bytes_per=2):
    """Analytical HBM bytes for each dataflow (the napkin math).

    Pallas keeps a block resident in VMEM while its index map is constant
    between consecutive grid steps, so with a single M block the WS output
    tile stays in VMEM across the whole K sweep (the VPU-local partial sum
    of the paper) and is written once."""
    m_blocks = max(1, m // bm)
    if m_blocks == 1:
        o_traffic_ws = m * n * 4                  # stays resident per (n,) tile
    else:
        o_traffic_ws = m * n * 4 * (2 * (k // bk) - 1)   # HBM read-mod-write
    ws = (k * n * bytes_per                      # weights once (stationary)
          + m * k * bytes_per * (n // bn)        # x re-streamed per n tile
          + o_traffic_ws)
    os_ = (m * k * bytes_per * (n // bn)
           + k * n * bytes_per * m_blocks        # weights re-fetched per m tile
           + m * n * 4)                          # output once
    return {"weight_stationary": ws, "output_stationary": os_}


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(dtype, w_slots: int) -> int:
    """Dynamic shared memory of one block (ws_matmul.cu Layout): the ring
    of STAGES x slices (128 x KS), then `w_slots` w slices (KS x 128),
    each row padded and each slice rounded up to 128 bytes."""
    ks, pad, _ = GEO[dtype]
    e = torch.tensor([], dtype=dtype).element_size()
    return (STAGES * _round128(e * MAX_BM * (ks + pad))
            + w_slots * _round128(e * ks * (MAX_BN + pad)))


def w_slots(dtype, bk: int, resident: bool) -> int:
    """The w slices a block holds (ws_matmul.cu Layout::w_slots): the
    whole bk-deep weight tile, at least STAGES slices, where several M
    tiles share it (`resident`); else STAGES, streamed as in OS."""
    slices = -(-bk // GEO[dtype][0])
    return max(slices, STAGES) if resident else STAGES


def blocks_per_sm(smem: int, resident: bool = False) -> int:
    """Blocks of one kernel that share an SM: as many as the SM's shared
    memory holds, at most the blocks its registers are bounded for:
    MIN_BLOCKS, or MIN_BLOCKS_RMW for WS's read-modify-write kernel
    (`resident`: several M tiles share the weight tile), which takes more
    than 128 registers.  Every layout takes more than a third of an SM,
    so shared memory or the bound decides."""
    bound = MIN_BLOCKS_RMW if resident else MIN_BLOCKS
    return min(bound, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))


@dataclass(frozen=True)
class Plan:
    """The blocks a call runs with and the shared memory they need."""
    m: int
    n: int
    k: int
    bm: int
    bn: int
    bk: int
    smem: int


def plan(x_shape, w_shape, dtype, block_m=DEF_BM, block_n=DEF_BN,
         block_k=DEF_BK, dataflow="ws") -> Plan:
    """The JAX function's blocks, `min(block, dim)`, and its assertions
    (`kernel.py:53-56`), then what the kernel can hold: bm and bn at
    most 128, and for `dataflow="ws"` the whole (bk x bn) weight tile
    beside the x ring in a block's shared memory (bk at most 640 in
    bf16, 320 in f32), whatever m is: the refusal is that of a block
    with several M tiles.  `smem` is that block's.  It never shrinks a
    block: what does not fit raises ValueError, on every device."""
    if len(x_shape) != 2 or len(w_shape) != 2:
        raise ValueError(f"shapes {tuple(x_shape)} @ {tuple(w_shape)}: want "
                         f"(M, K) @ (K, N)")
    (m, k), (k2, n) = x_shape, w_shape
    if k != k2:
        raise ValueError(f"x is (M, {k}) but w is ({k2}, N)")
    if min(m, n, k) < 1:
        raise ValueError(f"empty product {m} x {k} @ {k2} x {n}")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"(m, n, k) = ({m}, {n}, {k}) is not divisible by "
                         f"the blocks ({bm}, {bn}, {bk})")
    if bm > MAX_BM or bn > MAX_BN:
        raise ValueError(f"blocks ({bm}, {bn}): a block holds at most "
                         f"{MAX_BM} x {MAX_BN} output sums in registers")
    if dtype not in GEO:
        return Plan(m, n, k, bm, bn, bk, 0)
    slots = w_slots(dtype, bk, resident=True) if dataflow == "ws" else STAGES
    smem = smem_bytes(dtype, slots)
    if smem > MAX_SMEM:
        raise ValueError(
            f"a {bk} x {bn} {dtype} weight tile and the {STAGES}-stage x "
            f"ring need {smem} bytes of shared memory; a block has "
            f"{MAX_SMEM} (bk at most {MAX_BK[torch.bfloat16]} in bf16, "
            f"{MAX_BK[torch.float32]} in f32)")
    return Plan(m, n, k, bm, bn, bk, smem)


def _wave_fill(blocks: int, slots: int) -> float:
    """The share of `slots` x waves that `blocks` occupy."""
    return blocks / (-(-blocks // slots) * slots)


def ws_splits(m_tiles: int, n_tiles: int, sms: int) -> int:
    """S, the blocks that share one n tile's M tiles in the WS kernel,
    chosen by whole waves: the least S whose n_tiles * S blocks fill
    their waves of `sms` slots, the last one included, to at least 90 %
    (`_wave_fill`); where no S up to m_tiles does, the S of the fullest
    waves.  A wave is one block per SM, as WS's read-modify-write kernel
    runs wherever a block has more than one M tile (MIN_BLOCKS_RMW).
    Each block sweeps a long M range, so a partial last wave costs nearly
    a whole block's time.  Counted as the kernel launches them: each of
    the S blocks sweeps ceil(m_tiles / S) tiles, the last one the rest,
    so S is the number of blocks this leaves."""
    best = 1
    for s in range(1, m_tiles + 1):
        s = -(-m_tiles // -(-m_tiles // s))          # blocks actually launched
        fill = _wave_fill(n_tiles * s, sms)
        if fill >= 0.9:
            return s
        if fill > _wave_fill(n_tiles * best, sms):
            best = s
    return best


def _checked(x, w, p: Plan):
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"the kernels take float32 or bfloat16 x and w of "
                         f"one dtype, got {x.dtype} and {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(p.m, p.n, p.k) >= 2 ** 31:
        raise ValueError(f"dims ({p.m}, {p.n}, {p.k}) exceed the C "
                         f"interface's int")
    v = GEO[x.dtype][2]
    return int(p.k % v == 0 and p.n % v == 0 and p.bk % v == 0
               and p.bn % v == 0 and x.data_ptr() % 16 == 0
               and w.data_ptr() % 16 == 0)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launched_blocks_per_sm(dtype, dataflow: str, bk: int, per: int,
                           device=None) -> int:
    """Blocks per SM of the kernel a launch configures (WS with `per` M
    tiles per block at `bk`, or OS), from the card's occupancy API."""
    lib = B.library().lib
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.repro_matmul_blocks_per_sm(
            int(dataflow == "os"), DTYPE_CODES[dtype], bk, per,
            ctypes.byref(blocks))
    B.check(err, "matmul_blocks_per_sm")
    return blocks.value


@_trace.reporter
def _report(name, x, w, out):
    """A launch's work to the active traces: 2 m k n FLOPs, x and w read
    once, the f32 output written once."""
    _trace.kernel(name, flops=2 * x.shape[0] * x.shape[1] * w.shape[1],
                  bytes_read=_trace.tensors_bytes(x, w),
                  bytes_written=_trace.tensors_bytes(out), outputs=(out,))


def _launch_ws(x, w, p: Plan, splits=None):
    """The WS launch; `splits` overrides `ws_splits` (to time others)."""
    vec = _checked(x, w, p)
    m_tiles, n_tiles = p.m // p.bm, p.n // p.bn
    if splits is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = ws_splits(m_tiles, n_tiles, sms)
    out = torch.empty((p.m, p.n), dtype=torch.float32, device=x.device)
    lib = B.library().lib
    with torch.cuda.device(x.device):
        err = lib.repro_ws_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), p.m, p.n, p.k, p.bm,
            p.bn, p.bk, splits, DTYPE_CODES[x.dtype], vec, _stream(x))
    B.check(err, "ws_matmul")
    WS.launches += 1
    _report("ws_matmul", x, w, out)
    return out


def _launch_os(x, w, p: Plan):
    vec = _checked(x, w, p)
    if p.n // p.bn > 65535:
        raise ValueError(f"{p.n // p.bn} n tiles exceed the grid's 65535")
    out = torch.empty((p.m, p.n), dtype=torch.float32, device=x.device)
    lib = B.library().lib
    with torch.cuda.device(x.device):
        err = lib.repro_os_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), p.m, p.n, p.k, p.bm,
            p.bn, DTYPE_CODES[x.dtype], vec, _stream(x))
    B.check(err, "os_matmul")
    OS.launches += 1
    _report("os_matmul", x, w, out)
    return out


def _run(launch, dataflow, x, w, block_m, block_n, block_k):
    p = plan(tuple(x.shape), tuple(w.shape), x.dtype, block_m, block_n,
             block_k, dataflow)
    if B.plain_device(x):
        return matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"{dataflow}_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    return launch(x, w, p)


def ws_matmul(x, w, block_m=DEF_BM, block_n=DEF_BN, block_k=DEF_BK):
    """Weight-stationary x (M, K) @ w (K, N) -> (M, N) float32."""
    return _run(_launch_ws, "ws", x, w, block_m, block_n, block_k)


def os_matmul(x, w, block_m=DEF_BM, block_n=DEF_BN, block_k=DEF_BK):
    """Output-stationary twin of `ws_matmul` (the same function)."""
    return _run(_launch_os, "os", x, w, block_m, block_n, block_k)
