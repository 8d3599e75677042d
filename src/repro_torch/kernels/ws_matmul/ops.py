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
  kernel (`kernels/csrc/ws_matmul.cu`) or raises on a device, dtype,
  shape or layout it does not take; a CPU tensor takes `matmul_plain`.
  Both paths refuse what the JAX function asserts (a k mismatch, dims
  not divisible by `min(block, dim)`) and a block the kernel cannot hold
  (`plan`).  `WS.launches` and `OS.launches` count kernel launches.
* `matmul_plain` — `torch.matmul` in f32 (the oracle `ref.matmul_ref`).
* `hbm_traffic_model` — the TPU package's analytic byte count of the two
  grid orders, copied verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch

from repro_torch.kernels import build as B

DEF_BM, DEF_BN, DEF_BK = 128, 128, 128

# kernel launches since import (reset by callers that count a run)
WS = SimpleNamespace(launches=0)
OS = SimpleNamespace(launches=0)

# element-type codes of the C interface (csrc/ws_matmul.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel geometry (csrc/ws_matmul.cu Geo / Layout): the largest bm x bn
# a block holds in registers, and per dtype the depth of one staged
# slice, the shared row padding and the elements per 16-byte load
MAX_BM = MAX_BN = 128
GEO = {torch.bfloat16: (64, 8, 8), torch.float32: (32, 4, 4)}
MAX_SMEM = 232_448

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


def smem_bytes(dtype, w_rows: int) -> int:
    """Dynamic shared memory of one block (ws_matmul.cu Layout): a
    (128 x KS) slice of x and `w_rows` rows of w."""
    ks, pad, _ = GEO[dtype]
    e = torch.tensor([], dtype=dtype).element_size()
    return _round128(e * MAX_BM * (ks + pad)) + _round128(e * w_rows * (MAX_BN + pad))


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
    plus one slice of x in a block's shared memory.  It never shrinks a
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
    ks = GEO[dtype][0]
    w_rows = -(-bk // ks) * ks if dataflow == "ws" else ks
    smem = smem_bytes(dtype, w_rows)
    if smem > MAX_SMEM:
        raise ValueError(
            f"a {bk} x {bn} {dtype} weight tile and its x slice need "
            f"{smem} bytes of shared memory; a block has {MAX_SMEM}")
    return Plan(m, n, k, bm, bn, bk, smem)


def ws_splits(m_tiles: int, n_tiles: int, sms: int) -> int:
    """S, the blocks that share one n tile's M tiles in the WS kernel:
    the least S with n_tiles * S >= 2 * sms (two blocks per SM), at most
    m_tiles, counted as the kernel launches them (each of the S blocks
    sweeps ceil(m_tiles / S) tiles, the last one the rest)."""
    s = min(m_tiles, max(1, -(-2 * sms // n_tiles)))
    per = -(-m_tiles // s)
    return -(-m_tiles // per)


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


def _launch_ws(x, w, p: Plan):
    vec = _checked(x, w, p)
    m_tiles, n_tiles = p.m // p.bm, p.n // p.bn
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
    return out


def _run(launch, dataflow, x, w, block_m, block_n, block_k):
    p = plan(tuple(x.shape), tuple(w.shape), x.dtype, block_m, block_n,
             block_k, dataflow)
    if x.device.type == "cpu":
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
