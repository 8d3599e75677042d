"""Flash attention (causal or not, GQA) over contiguous Q/K/V: the Hopper
kernel's wrapper and its plain PyTorch version.

Port of `repro.kernels.flash_attention` (TPU kernel
`flash_attention_pallas`, kernel.py:64).  q (b, sq, hq, d) attends over
k, v (b, skv, hkv, d); query head h reads kv head h // (hq // hkv)
without a repeated K/V.  `q_offset` places the queries at absolute
positions q_offset .. q_offset + sq - 1 (the chunked-prefill geometry);
keys at or past skv are masked, and with `causal` a query sees the keys
at or before its own position.

* `flash_attention` — the serving entry point, forward only.  A CUDA
  tensor launches the hand-written kernel (`kernels/csrc/
  flash_attention.cu`) or raises on a device, dtype, shape or layout it
  does not take; a CPU tensor takes the plain version.  There is no
  fallback between the two.  `launches` counts kernel launches.  It
  raises when grad is enabled and an input requires grad: its result
  would carry no gradient, so training goes through `FlashAttentionFn`.
* `flash_attention_plain` — one masked f32 softmax in batched torch.
* Training: `FlashAttentionFn` (a `torch.autograd.Function`) runs the
  forward with the log-sum-exp (`flash_attention_lse`) and saves q, k,
  v, o and lse; its backward is `flash_attention_backward`, the kernel
  of `kernels/csrc/flash_attention_bwd.cu` (D = rowsum(dO o), then
  dK/dV, then, where the group is split, the reduce of its partials,
  then dQ; `BACKWARD.launches` counts calls) on a CUDA tensor and
  `flash_attention_backward_plain` on a CPU one.  The backward takes
  head dims that are multiples of 16 up to 128 and, in bf16, of 32 from
  160 to 256 (f32: of 16 up to 256).  bf16 has two designs, chosen by
  the head dim alone (`bwd_design`): wgmma at 64 to 192, with the group
  split over blocks where the key tiles alone leave the card half idle
  (`bwd_group_splits`); mma.sync at 16 to 48 and at 224 and 256, whose
  blocks past 128 split the output columns in two halves
  (`bwd_col_splits`).

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

The reference has no backward kernel (it differentiates its XLA path,
`flash_xla_attention`), so the backward is the port's own: with P =
exp(S - lse), D = rowsum(dO o), dV = P^T dO, dS = P (dO v^T - D), dQ =
dS k / sqrt(d) and dK = dS^T q / sqrt(d), summed over each kv head's
query group.  The bf16 kernel rounds P and dS to bf16 before its
tensor-core products, as the forward rounds p; the plain version rounds
at the same places, so `tolerance.py` holds the two as it holds the
forwards.  In f32 and f64 nothing is rounded, and the plain version
equals autograd over `flash_attention_plain`.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace
from repro_torch.kernels.paged_prefill.ops import (BLOCK_RESERVED_SMEM,
                                                   SM_SMEM)

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run): the
# forward's, and the backward's (one per call of its three kernels)
launches = 0
BACKWARD = SimpleNamespace(launches=0)

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
MAX_BWD_HEAD_DIM = 256
# past this head dim the bf16 mma.sync backward's blocks each sum one
# column half of dK/dV and dQ in registers (flash_attention_bwd.cu
# `col_splits`), so its head dims (`tc::dispatch`) are multiples of 16 up
# to it, then of 32
BWD_SPLIT_HEAD_DIM = 128
BWD_TC_HEAD_DIMS = (*range(16, BWD_SPLIT_HEAD_DIM + 1, 16),
                    *range(BWD_SPLIT_HEAD_DIM + 32, MAX_BWD_HEAD_DIM + 1, 32))
MAX_GRID_Y = 65535
# the backward's geometry (flash_attention_bwd.cu): bf16 dK/dV blocks of
# 64 keys walking 32 packed query rows a step, dQ blocks of 64 packed rows
# over 64-key tiles (TC_ROWS, TC_TILE_TOKENS); f32 tiles of 32
BWD_TC_KEYS, BWD_TC_QROWS = 64, 32
BWD_F32_TILE = 32
# the bf16 backward's two designs, chosen by head dim alone (`bwd_design`):
# wgmma at these (flash_attention_bwd.cu `wg::takes`), mma.sync at the rest
WGMMA, MMA_SYNC = "wgmma", "mma_sync"
BWD_WG_HEAD_DIMS = (64, 80, 96, 112, 128, 160, 192)
# the wgmma design's geometry (namespace wg): dK/dV blocks of 128 keys (two
# consumer warpgroups of 64) walking 64 packed query rows a step, dQ blocks
# of 128 packed rows over 64-key tiles, a ring fed by a producer warpgroup
# (384 threads), 3 stages deep up to 128 columns (d padded to whole
# 64-column panels) and 2 past it, where each dK/dV tile takes two blocks,
# one summing dV and one dK (`bwd_wg_roles`); a dK/dV tile's walk split
# over at most MAX_GROUP_SPLITS blocks
BWD_WG_KEYS, BWD_WG_QROWS = 128, 64
BWD_WG_ROWS, BWD_WG_TOKENS = 128, 64
BWD_WG_THREADS = 384
MAX_GROUP_SPLITS = 16
# the passes of one backward call, bits of the C entry point's `passes`
# (flash_attention_bwd.cu `Pass`): D, dK/dV, the group split's reduce, dQ
BWD_PASSES = {"D": 1, "dkdv": 2, "reduce": 4, "dq": 8}
BWD_ALL_PASSES = sum(BWD_PASSES.values())

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"


def _compute_dtype(dtype):
    """The plain versions' arithmetic: f32, or f64 for f64 inputs (the
    gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mask(sq: int, skv: int, q_offset: int, device):
    """(sq, skv) bool: query i (at q_offset + i) sees the keys at or
    before its position."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    return qpos >= torch.arange(skv, device=device)[None, :]


def flash_attention_lse_plain(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (o (b, sq, hq, d) in
    q's dtype, lse (b, hq, sq): m + log(l) in f32 (f64 for f64 inputs),
    -inf where a row sees no key)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ct = _compute_dtype(q.dtype)
    qg = q.reshape(b, sq, hkv, g, d).to(ct)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(ct)) * (1.0 / math.sqrt(d))
    if causal:
        mask = _mask(sq, skv, q_offset, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                         # (b,h,g,q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(ct), v.to(ct))
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    lse = (m[..., 0] + torch.log(l)).reshape(b, hq, sq)
    return o.reshape(b, sq, hq, d).to(q.dtype), lse


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d) in
    q's dtype."""
    return flash_attention_lse_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)[0]


def flash_attention_backward_plain(q, k, v, o, do, lse, *, causal=True,
                                   q_offset=0):
    """The gradient of `flash_attention_plain` at (q, k, v) for the
    output gradient `do`, from the forward's `o` and `lse` (the kernel's
    inputs): (dq, dk, dv) in the inputs' dtypes.  P and dS are rounded to
    v's and q's dtype before the products, as the kernel rounds them; a
    row whose lse is -inf (it sees no key) gets zero gradient."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ct = _compute_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).to(ct)
    dog = do.reshape(b, sq, hkv, g, d).to(ct)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    lse = lse.reshape(b, hkv, g, sq, 1).to(ct)
    finite = torch.isfinite(lse)
    live = finite & _mask(sq, skv, q_offset, q.device) if causal else finite
    p = torch.where(live, torch.exp(s - torch.where(finite, lse, 0.0)), 0.0)
    dsum = (do.to(ct) * o.to(ct)).sum(-1)                     # (b, sq, hq)
    dsum = dsum.reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - dsum)
    p = p.to(v.dtype).to(ct)
    ds = ds.to(q.dtype).to(ct)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def _check_inputs(q, k, v, q_offset: int, max_d: int, tensors=()):
    """The checks every launch makes; `tensors` are further (name,
    tensor) pairs of q's dtype and shape (the backward's o and dO)."""
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
    for name, t in tensors:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must have q's dtype and shape")
    for name, t in (("q", q), ("k", k), ("v", v), *tensors):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d % 16 or d > max_d:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 16 "
                         f"up to {max_d}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    return b, sq, skv, hq, hkv, d


def _launch(q, k, v, causal: bool, q_offset: int, with_lse: bool = False):
    """The forward kernel: out, or (out, lse (b, hq, sq) f32) with
    `with_lse` (the training entry point)."""
    global launches
    b, sq, skv, hq, hkv, d = _check_inputs(q, k, v, q_offset, MAX_HEAD_DIM)
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
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if sq == 0:
        return (out, lse) if with_lse else out
    lib = B.library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (b, sq, skv, hq, hkv, d, int(q_offset), int(causal),
                DTYPE_CODES[q.dtype], stream)
        if with_lse:
            err = lib.repro_flash_attention_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *args)
        else:
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args)
    B.check(err, "flash_attention")
    launches += 1
    _report(q, k, v, causal, q_offset, (out, lse) if with_lse else (out,))
    return (out, lse) if with_lse else out


@_trace.reporter
def _report(q, k, v, causal, q_offset, outs):
    """A forward launch's work to the active traces: 4 hq d FLOPs per
    (query, key) pair seen, q, k, v read once, the outputs written."""
    b, sq, hq, d = q.shape
    pairs = b * _trace.seen_pairs(sq, k.shape[1], causal, q_offset)
    _trace.kernel("flash_attention", flops=4 * hq * d * pairs,
                  bytes_read=_trace.tensors_bytes(q, k, v),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


@_trace.reporter
def _report_bwd(q, k, v, o, do, lse, causal, q_offset, outs):
    """A backward launch's work: 2.5 x the forward's FLOPs over the pairs
    seen, q, k, v, o, dO and lse read, dq, dk, dv written."""
    b, sq, hq, d = q.shape
    pairs = b * _trace.seen_pairs(sq, k.shape[1], causal, q_offset)
    _trace.kernel("flash_attention_backward",
                  flops=2.5 * 4 * hq * d * pairs,
                  bytes_read=_trace.tensors_bytes(q, k, v, o, do, lse),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


def bwd_col_splits(d: int) -> int:
    """Column halves of the bf16 mma.sync backward's outputs, its grids'
    z (flash_attention_bwd.cu `col_splits`)."""
    return 1 if d <= BWD_SPLIT_HEAD_DIM else 2


def bwd_design(d: int) -> str:
    """The bf16 backward's design at head dim d (flash_attention_bwd.cu
    `wg::takes`): `wgmma` at 64 to 128, 160 and 192, `mma_sync` at 16
    to 48, 224 and 256."""
    return WGMMA if d in BWD_WG_HEAD_DIMS else MMA_SYNC


def bwd_wg_padded(d: int) -> int:
    """The wgmma design's tile width: d in whole 64-column panels
    (flash_attention_bwd.cu `wg::padded`)."""
    return -(-d // 64) * 64


def bwd_wg_stages(d: int) -> int:
    """The wgmma design's ring depth (`wg::stages`)."""
    return 3 if bwd_wg_padded(d) <= 128 else 2


def bwd_wg_roles(d: int) -> int:
    """Blocks a dK/dV tile of the wgmma design takes (its grid's z,
    `wg::wide`): one summing dV and dK up to 128 columns, past it one for
    dV and one for dK."""
    return 1 if bwd_wg_padded(d) <= 128 else 2


def bwd_wg_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory of one dK/dV block and one dQ block of the
    wgmma design (flash_attention_bwd.cu `wg::dkdv_smem_bytes`,
    `wg::dq_smem_bytes`): 1024 bytes of alignment, bf16 tiles of whole
    64-column panels, the ring's lse, D and key limits (dK/dV), and its
    2 x stages mbarriers."""
    st = bwd_wg_stages(d)
    d = bwd_wg_padded(d)
    return (1024 + 2 * (2 * BWD_WG_KEYS + st * 2 * BWD_WG_QROWS) * d
            + st * BWD_WG_QROWS * 12 + st * 16,
            1024 + 2 * (2 * BWD_WG_ROWS + st * 2 * BWD_WG_TOKENS) * d
            + st * 16)


def bwd_group_splits(b: int, sq: int, skv: int, hkv: int, group: int,
                     sms: int, d: int = 128) -> int:
    """Blocks each 128-key dK/dV tile's walk is split over (the grid's y
    holds tile x splits): 1 when the tiles alone (and their roles,
    `bwd_wg_roles`) give two blocks an SM; else enough for two, but no
    chunk shorter than 4 steps of 64 packed rows of the longest walk, and
    at most MAX_GROUP_SPLITS."""
    blocks = b * hkv * -(-skv // BWD_WG_KEYS) * bwd_wg_roles(d)
    if blocks >= 2 * sms:
        return 1
    steps = -(-sq * group // BWD_WG_QROWS)
    return max(1, min(-(-2 * sms // blocks), steps // 4, MAX_GROUP_SPLITS))


def bwd_chunk(n_steps: int, splits: int, c: int) -> tuple[int, int]:
    """Steps j0 .. j1 - 1 of a walk of n_steps that chunk c of `splits`
    takes (the kernel's `j0`, `j1`): equal shares, one step apart at
    most."""
    return n_steps * c // splits, n_steps * (c + 1) // splits


def bwd_blocks(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
               splits: int = 1) -> dict:
    """The bf16 backward's grid sizes at head dim d: {"dkdv": ..., "dq":
    ...} blocks (with the group split's `splits`)."""
    group = hq // hkv
    if bwd_design(d) == WGMMA:
        return {"dkdv": b * hkv * -(-skv // BWD_WG_KEYS) * splits
                * bwd_wg_roles(d),
                "dq": b * hkv * -(-sq * group // BWD_WG_ROWS)}
    return {"dkdv": b * hkv * -(-skv // BWD_TC_KEYS) * bwd_col_splits(d),
            "dq": b * hkv * tc_tiles(sq, group) * bwd_col_splits(d)}


_SMS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def bwd_smem_bytes(dtype, d: int) -> tuple[int, int]:
    """Dynamic shared memory of one dK/dV block and one dQ block of the
    backward (flash_attention_bwd.cu `dkdv_smem_bytes`, `dq_smem_bytes`,
    the wgmma design's `bwd_wg_smem_bytes` and `f32::smem_bytes`)."""
    if route(dtype) == TENSOR_CORES and bwd_design(d) == WGMMA:
        return bwd_wg_smem_bytes(d)
    if route(dtype) == TENSOR_CORES:
        row = 2 * (d + TC_PAD)
        return ((2 * BWD_TC_KEYS + 2 * TC_STAGES * BWD_TC_QROWS) * row
                + 4 * 2 * TC_STAGES * BWD_TC_QROWS,
                (2 * TC_ROWS + 2 * TC_STAGES * TC_TILE_TOKENS) * row)
    t = BWD_F32_TILE
    tile = _round128(4 * t * (d + 4))
    score = _round128(4 * t * (t + 1))
    small = 2 * _round128(4 * t)
    return 6 * tile + 2 * score + small, 5 * tile + score + small


def _launch_bwd(q, k, v, o, do, lse, causal: bool, q_offset: int,
                passes: int = BWD_ALL_PASSES, bufs: dict | None = None):
    """The backward kernel's passes named by the bits of `passes` (all by
    default) into `bufs` (`_bwd_buffers`; fresh ones by default), whose
    dq, dk and dv it returns.  A timing of one pass reuses the buffers of
    a whole call."""
    b, sq, skv, hq, hkv, d = _check_inputs(
        q, k, v, q_offset, MAX_BWD_HEAD_DIM, (("o", o), ("do", do)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be contiguous float32 ({b}, {hq}, {sq}) "
                         f"on {q.device}")
    # the grids' y extents: (dK/dV key tiles, dQ row tiles or heads)
    splits = _bwd_splits(q, k)
    if route(q.dtype) == TENSOR_CORES:
        if d not in BWD_TC_HEAD_DIMS:
            raise ValueError(f"head_dim {d}: the bf16 backward takes "
                             f"{BWD_TC_HEAD_DIMS}")
        if bwd_design(d) == WGMMA:
            grid_y = (-(-skv // BWD_WG_KEYS) * splits,
                      -(-sq * (hq // hkv) // BWD_WG_ROWS))
        else:
            grid_y = (-(-skv // BWD_TC_KEYS), tc_tiles(sq, hq // hkv))
    else:
        grid_y = (-(-skv // BWD_F32_TILE), b * hq)
    if max(grid_y) > MAX_GRID_Y:
        raise ValueError(f"sq {sq}, skv {skv} or b * hq {b * hq} exceeds "
                         f"the grid")
    if max(bwd_smem_bytes(q.dtype, d)) > MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than a "
                         f"block has")
    if bufs is None:
        bufs = _bwd_buffers(q, k, splits)
    dq, dk, dv = bufs["dq"], bufs["dk"], bufs["dv"]
    if sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    part = bufs["part"]
    lib = B.library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), bufs["dsum"].data_ptr(),
            part.data_ptr() if part is not None else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, d,
            int(q_offset), int(causal), splits, DTYPE_CODES[q.dtype],
            int(passes), stream)
    B.check(err, "flash_attention_backward")
    BACKWARD.launches += 1
    _report_bwd(q, k, v, o, do, lse, causal, q_offset, (dq, dk, dv))
    return dq, dk, dv


def _bwd_splits(q, k) -> int:
    """The group split a call takes: `bwd_group_splits` on the wgmma
    design, else 1."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if route(q.dtype) != TENSOR_CORES or bwd_design(d) != WGMMA:
        return 1
    return bwd_group_splits(b, sq, skv, hkv, hq // hkv, _sm_count(q.device),
                            d)


def _bwd_buffers(q, k, splits: int) -> dict:
    """The backward's outputs and scratch: dq, dk, dv, D (b, hq, sq) f32,
    and with a group split the f32 partials (splits, 2, b, skv, hkv, d)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    return {"dq": torch.empty_like(q), "dk": torch.empty_like(k),
            "dv": torch.empty_like(k),
            "dsum": torch.empty((b, hq, sq), dtype=torch.float32,
                                device=q.device),
            "part": (torch.empty((splits, 2, b, skv, hkv, d),
                                 dtype=torch.float32, device=q.device)
                     if splits > 1 else None)}


def backward_pass_timer(q, k, v, o, do, lse, *, causal=True, q_offset=0):
    """For timing the backward kernel's passes apart on the card: runs
    one whole call, then returns ({pass name: a callable that launches
    only that pass into the same buffers}, the group split).  The reduce
    is there only when the group is split."""
    splits = _bwd_splits(q, k)
    bufs = _bwd_buffers(q, k, splits)
    _launch_bwd(q, k, v, o, do, lse, causal, q_offset, bufs=bufs)
    return {name: (lambda bit=bit: _launch_bwd(
        q, k, v, o, do, lse, causal, q_offset, passes=bit, bufs=bufs))
        for name, bit in BWD_PASSES.items()
        if name != "reduce" or splits > 1}, splits


def _device(q, what: str) -> str:
    """"cpu" where q takes the plain version (`build.plain_device`),
    "cuda" where it launches the kernel."""
    if B.plain_device(q):
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return "cuda"


def flash_attention(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) in q's dtype ->
    (b, sq, hq, d) in q's dtype.  Forward only: raises when grad is
    enabled and an input requires grad (use `FlashAttentionFn`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention is the forward-only launcher and its result "
            "carries no gradient; differentiate through "
            "FlashAttentionFn.apply(q, k, v, causal, q_offset)")
    if _device(q, "flash_attention") == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return _launch(q, k, v, causal, q_offset)


def flash_attention_lse(q, k, v, *, causal=True, q_offset=0):
    """The training forward: (o (b, sq, hq, d), lse (b, hq, sq)), the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if _device(q, "flash_attention_lse") == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)
    return _launch(q, k, v, causal, q_offset, with_lse=True)


def flash_attention_backward(q, k, v, o, do, lse, *, causal=True,
                             q_offset=0):
    """(dq, dk, dv) of the attention at (q, k, v) for the output
    gradient `do`, from the forward's o and lse: the backward kernel on a
    CUDA tensor, `flash_attention_backward_plain` on a CPU one."""
    if _device(q, "flash_attention_backward") == "cpu":
        return flash_attention_backward_plain(q, k, v, o, do, lse,
                                              causal=causal,
                                              q_offset=q_offset)
    return _launch_bwd(q, k, v, o, do, lse, causal, q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with the
    log-sum-exp, and the backward kernel, on the card (their plain
    versions on the CPU).  `FlashAttentionFn.apply(q, k, v, causal,
    q_offset)` -> (b, sq, hq, d)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, lse = flash_attention_lse(q, k, v, causal=causal,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, do.contiguous(), lse, causal=ctx.causal,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
