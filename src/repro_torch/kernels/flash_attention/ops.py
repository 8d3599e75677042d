"""Flash attention (causal or not, GQA) over contiguous Q/K/V: the Hopper
kernel's wrapper and its plain PyTorch version.

Port of `repro.kernels.flash_attention` (TPU kernel
`flash_attention_pallas`, kernel.py:64).  q (b, sq, hq, d) attends over
k, v (b, skv, hkv, d); query head h reads kv head h // (hq // hkv)
without a repeated K/V.  `q_offset` places the queries at absolute
positions q_offset .. q_offset + sq - 1 (the chunked-prefill geometry);
keys at or past skv are masked, and with `causal` a query sees the keys
at or before its own position.

* `flash_attention` — the entry point.  A CUDA tensor launches the
  hand-written kernel (`kernels/csrc/flash_attention.cu`) or raises on a
  device, dtype, shape or layout it does not take; a CPU tensor takes
  the plain version.  There is no fallback between the two.  `launches`
  counts kernel launches.
* `flash_attention_plain` — one masked f32 softmax in batched torch.

The kernel has two designs, fixed by the dtype (`route`); neither falls
back to the other:

* bf16, what every served configuration runs: a flash-style
  tensor-core kernel (mma.sync bf16 -> f32).  A block takes 64 packed
  (query position, group member) rows of one (batch row, kv head), so
  the whole GQA group shares each K/V tile; 64-key K/V tiles arrive
  through a 2-stage cp.async ring; the online softmax and the O
  accumulator stay in registers.  Head dims: multiples of 16 up to 256.
* f32, taken only by the parity checks: CUDA cores, 32 x 32 tiles
  (tensor cores would make it TF32, which the port never uses).

Both compute scores in f32, keep l as the sum of the f32
probabilities, and round p to V's dtype before the PV product, as the
TPU kernel does (kernel.py:57): bf16 rounds p there, f32 is exact.  The
kernel takes any sq and skv (the TPU kernel asserts sq % block_q == 0
and pads K/V to its block).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.paged_prefill.ops import (BLOCK_RESERVED_SMEM,
                                                   SM_SMEM)

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run)
launches = 0

# element-type codes of the C interface (csrc/flash_attention.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the f32 CUDA-core design's geometry (flash_attention.cu Layout): query
# rows, keys and shared-memory row padding per tile
F32_TILE = (32, 32, 4)
# the bf16 tensor-core design's geometry (flash_attention.cu namespace tc)
TC_ROWS = 64           # packed query rows per block, 16 per warp
TC_TILE_TOKENS = 64    # keys per K/V tile
TC_STAGES = 2          # K/V tiles in flight (cp.async ring)
TC_PAD = 8             # bf16 elements of shared-memory row padding
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d) in
    q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                         # (b,h,g,q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, hq, d).to(q.dtype)


# ----------------------------------------------------------- the kernel

def route(dtype) -> str:
    """Which design takes a dtype: bf16 on tensor cores, f32 on CUDA
    cores."""
    return TENSOR_CORES if dtype == torch.bfloat16 else CUDA_CORES


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core block
    (flash_attention.cu `tc::smem_bytes`): Q and the K/V ring in bf16 at
    row stride d + 8."""
    return 2 * (1 + 2 * TC_STAGES) * TC_ROWS * (d + TC_PAD)


def tc_blocks_per_sm(d: int) -> int:
    """Tensor-core blocks resident on one SM, as shared memory allows."""
    return SM_SMEM // (tc_smem_bytes(d) + BLOCK_RESERVED_SMEM)


def tc_tiles(sq: int, group: int) -> int:
    """Blocks of packed rows per (batch row, kv head): the tensor-core
    grid is (b * hkv, tc_tiles(sq, group))."""
    return -(-sq * group // TC_ROWS)


def smem_bytes(dtype, d: int) -> int:
    """Dynamic shared memory of one block of the design `dtype` takes
    (the f32 one: flash_attention.cu Layout, f32 Q/K/V, S/P, O, m, l)."""
    if route(dtype) == TENSOR_CORES:
        return tc_smem_bytes(d)
    bq, bkv, pad = F32_TILE
    ldq, lds, ldo = d + pad, bkv + 4, d + 4
    return (_round128(4 * bq * ldq) + 2 * _round128(4 * bkv * ldq)
            + _round128(4 * bq * lds) + _round128(4 * bq * ldo)
            + 2 * _round128(4 * bq))


def _launch(q, k, v, causal: bool, q_offset: int):
    global launches
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v must have q's dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("want q (b, sq, hq, d) and k, v (b, skv, hkv, d)")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    if route(q.dtype) == TENSOR_CORES:
        if tc_tiles(sq, hq // hkv) > MAX_GRID_Y or b * hkv >= 2 ** 31:
            raise ValueError(f"sq {sq} x group {hq // hkv} or b * hkv "
                             f"{b * hkv} exceeds the grid")
    elif b * hq > MAX_GRID_Y:
        raise ValueError(f"b * hq = {b * hq} exceeds the grid's "
                         f"{MAX_GRID_Y}")
    if smem_bytes(q.dtype, d) > MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than a "
                         f"block has")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    lib = B.library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, d, int(q_offset), int(causal),
            DTYPE_CODES[q.dtype], stream)
    B.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) in q's dtype ->
    (b, sq, hq, d) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, q_offset)
