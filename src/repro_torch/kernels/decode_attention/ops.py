"""Split-KV decode attention (flash-decoding) over a contiguous cache:
the Hopper kernel's wrapper, its plain PyTorch version and the combine.

Port of `repro.kernels.decode_attention` (TPU kernel
`decode_attention_pallas`, kernel.py:51).  One decode query per batch
row attends over its row of a contiguous (b, S, hkv, d) cache, masked
to the positions `kv_pos <= positions[b]`.  The S axis is cut into
`kv_splits` slices; each (batch row, kv head, split) reduces its slice
for the `group` query heads that share the kv head into an f32
online-softmax summary (m, l, acc), and `combine_splits` merges the
summaries by log-sum-exp (the reference computes that merge outside
Pallas, in XLA).

* `decode_attention` — the entry point.  A CUDA tensor launches the
  hand-written kernels (`kernels/csrc/decode_attention.cu`) on the
  current stream, with no PyTorch arithmetic between or after them, or
  raises on a device, dtype, shape or layout they do not take; a CPU
  tensor takes the plain version.  There is no fallback between the
  two.  The design is fixed by the dtype (`route`), with no fallback
  either way:
    - bf16: one launch of a tensor-core kernel (head dims that are
      multiples of 16 up to 256, query groups of at most
      TC_GROUP_ROWS).  Block (batch row x kv head, split) walks its
      split through a 2-stage cp.async ring of 64-row bf16 tiles; the
      query group is one m16 tile of mma.sync products; p is rounded to
      bf16 before the PV product.  The splits merge in the same launch:
      each live split writes its f32 summary to the device's scratch
      and the last to arrive (an atomic ticket per batch row and kv
      head) merges them.  A split past the row's position exits at
      once; the host never reads `positions`.
    - f32: the CUDA-core split kernel, then the combine kernel.
  `launches` counts the split kernel's launches (either design),
  `COMBINE.launches` the combine kernel's (`combine_splits_kernel`,
  f32 only on this path).
* `decode_attention_plain` — the same function in batched torch.
* `combine_splits` — the merge in plain PyTorch: the combine kernel's
  plain version.
* `decode_partials` / `decode_partials_plain` — the split summaries
  (m, l, acc) before the merge, from the kernel (bf16: the same
  tensor-core kernel with its merge skipped) or in batched torch.

Where the port differs from the TPU kernel, with the same result:
  * any S: a split is `ceil(S / kv_splits)` rows and the last one is
    shorter (the TPU kernel asserts `S % kv_splits == 0`); splits past
    S are empty;
  * rows past `positions[b]` are skipped, not masked (the bf16 kernel
    zero-fills them without a read, so a NaN there stays out of the
    output).  A split with no visible row has m = -1e30, l = 0 and acc
    = 0 (the TPU kernel's has m = -1e30 and p = exp(0) per masked row);
    `combine_splits` weights it by exp(-1e30 - m_max) = 0 either way.
    A position at or past S (an idle engine row whose write was clamped
    to S - 1) sees every row, as `kv_pos <= pos` says.
Both versions compute scores in f32, keep l as the sum of the f32
probabilities, and round p to V's dtype before the PV product, as the
TPU kernel does (kernel.py:45): bf16 rounds p there, f32 is exact.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace
from repro_torch.kernels.paged_attention.ops import _ptr, _scratch

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run): the
# split kernel's, and the combine kernel's
launches = 0
COMBINE = SimpleNamespace(launches=0)

# element-type codes of the C interface (csrc/decode_attention.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"

# kernel geometry limits (csrc/decode_attention.cu)
THREADS = 128
MAX_ROW_ELEMS = THREADS * 32
TILE_TOKENS = 32
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256
# the bf16 tensor-core design (csrc/decode_attention.cu namespace dec_tc)
TC_GROUP_ROWS = 16     # query group rows per block: one m16 tile
TC_WARPS = 4           # each takes 16 cache rows of a tile
TC_TILE_TOKENS = 64    # cache rows per tile
TC_STAGES = 2          # K/V tiles in flight (cp.async ring)
TC_PAD = 8             # bf16 elements of shared-memory row padding


def split_len(S: int, kv_splits: int) -> int:
    """Rows of the cache in each split (the last split may be shorter)."""
    return max(1, -(-S // kv_splits))


def combine_splits(m, l, acc, b: int, hq: int, d: int, out_dtype):
    """Merge per-split partial softmax summaries: the log-sum-exp
    reduction of the reference (kernel.py:94).  m, l: (b*hkv, splits,
    group); acc: (b*hkv, splits, group, d).  Returns (b, hq, d)."""
    m_max = m.amax(dim=1, keepdim=True)                       # (bh,1,g)
    corr = torch.exp(m - m_max)                               # (bh,s,g)
    l_tot = (l * corr).sum(dim=1)                             # (bh,g)
    acc_tot = (acc * corr[..., None]).sum(dim=1)              # (bh,g,d)
    o = acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return o.reshape(b, hq, d).to(out_dtype)


def decode_partials_plain(q, k_cache, v_cache, positions, *, kv_splits=8):
    """q: (b, hq, d); k_cache/v_cache: (b, S, hkv, d); positions: (b,)
    inclusive newest index.  Returns the split summaries m, l
    (b*hkv, kv_splits, group) and acc (b*hkv, kv_splits, group, d), f32."""
    b, hq, d = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    L = split_len(S, kv_splits)
    pad = kv_splits * L - S
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) / math.sqrt(d)
    kv_pos = torch.arange(kv_splits * L, device=q.device)
    mask = (kv_pos[None, :] <= positions.long()[:, None]) & (kv_pos < S)
    mask = mask.reshape(b, 1, 1, kv_splits, L)
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    s = s.reshape(b, hkv, g, kv_splits, L)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                        # (b,hkv,g,c)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    v = torch.nn.functional.pad(v_cache, (0, 0, 0, 0, 0, pad))
    v = v.reshape(b, kv_splits, L, hkv, d)
    acc = torch.einsum("bhgcl,bclhd->bhgcd", p.to(v.dtype).float(), v.float())
    m = m.permute(0, 1, 3, 2).reshape(b * hkv, kv_splits, g)
    l = l.permute(0, 1, 3, 2).reshape(b * hkv, kv_splits, g)
    acc = acc.permute(0, 1, 3, 2, 4).reshape(b * hkv, kv_splits, g, d)
    return m, l, acc


def decode_attention_plain(q, k_cache, v_cache, positions, *, kv_splits=8):
    """`decode_partials_plain` merged by `combine_splits`: (b, hq, d) in
    q's dtype."""
    b, hq, d = q.shape
    m, l, acc = decode_partials_plain(q, k_cache, v_cache, positions,
                                      kv_splits=kv_splits)
    return combine_splits(m, l, acc, b, hq, d, q.dtype)


# ----------------------------------------------------------- the kernel

def route(dtype) -> str:
    """Which design takes q's dtype: bf16 the tensor-core kernel (one
    launch), f32 the CUDA-core split kernel and the combine kernel."""
    return TENSOR_CORES if dtype == torch.bfloat16 else CUDA_CORES


def smem_bytes(group: int, d: int) -> int:
    """Dynamic shared memory of one CUDA-core split block
    (decode_attention.cu `smem_bytes`)."""
    t = TILE_TOKENS
    return 4 * (group * (d + 1) + t * (d + 1) + t * d + group * t + 3 * group)


def tc_smem_bytes(d: int, splits: int) -> int:
    """Dynamic shared memory of one tensor-core block
    (decode_attention.cu `dec_tc::smem_bytes`): Q in bf16 at row stride
    d + 8, then the K/V ring, whose space the merges take after the walk
    (the warps' f32 O, m, l and weights and the block's m and l; then
    the splits' m and l and the merged l)."""
    rows, warps = TC_GROUP_ROWS, TC_WARPS
    ring = 2 * 2 * TC_STAGES * TC_TILE_TOKENS * (d + TC_PAD)
    merge = 4 * max(warps * rows * (d + 3) + 2 * rows, (2 * splits + 2) * rows)
    return 2 * rows * (d + TC_PAD) + max(ring, merge)


def check_inputs(q, k_cache, v_cache, positions, kv_splits: int) -> None:
    """Raise ValueError on anything the kernel of q's dtype (`route`)
    does not take."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("the caches must have q's dtype")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("want q (b, hq, d) and caches (b, S, hkv, d)")
    b, hq, d = q.shape
    _, S, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (b,):
        raise ValueError("positions must be int32 (b,)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_splits < 1 or b * hkv > 2 ** 31 - 1 or kv_splits > 65535:
        raise ValueError(f"grid of {b * hkv} x {kv_splits} out of range")
    g = hq // hkv
    if route(q.dtype) == TENSOR_CORES:
        if d % 16 or d > MAX_HEAD_DIM:
            raise ValueError(f"head_dim {d}: the bf16 decode kernel takes "
                             f"multiples of 16 up to {MAX_HEAD_DIM}")
        if g > TC_GROUP_ROWS:
            raise ValueError(f"query group {g}: the bf16 decode kernel "
                             f"takes at most {TC_GROUP_ROWS} rows per kv head")
        if tc_smem_bytes(d, kv_splits) > MAX_SMEM:
            raise ValueError(f"{kv_splits} splits need more shared memory "
                             f"to merge than a block has")
        return
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if g * d > MAX_ROW_ELEMS:
        raise ValueError(f"{g} query rows x head_dim {d} exceed one block's "
                         f"{MAX_ROW_ELEMS} accumulators")
    if smem_bytes(g, d) > MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than a "
                         f"block has")


def _launch(q, k_cache, v_cache, positions, kv_splits: int, partials: bool):
    """One launch of the split kernel.  Returns the summaries (m, l, acc)
    with `partials` or in f32 (the combine makes the output), else the
    bf16 output (the tensor-core kernel merges its splits itself, through
    the device's scratch and tickets, `paged_attention.ops._scratch`,
    which reallocates when a call needs more: a captured CUDA graph would
    have to hold the largest first)."""
    global launches
    check_inputs(q, k_cache, v_cache, positions, kv_splits)
    b, hq, d = q.shape
    _, S, hkv, _ = k_cache.shape
    g = hq // hkv
    dev = q.device
    merged = route(q.dtype) == TENSOR_CORES and not partials
    out = m = l = acc = part = tickets = None
    if merged:
        out = torch.empty_like(q)
        part, tickets = _scratch(dev, (2 + d) * b * hq * kv_splits, b * hkv)
    else:
        m = torch.empty((b * hkv, kv_splits, g), dtype=torch.float32,
                        device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b * hkv, kv_splits, g, d), dtype=torch.float32,
                          device=dev)
    lib = B.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), _ptr(out), _ptr(m), _ptr(l), _ptr(acc),
            _ptr(part), _ptr(tickets), b, hq, hkv, S, d, kv_splits,
            split_len(S, kv_splits), int(partials), DTYPE_CODES[q.dtype],
            stream)
    B.check(err, "decode_attention")
    launches += 1
    _report(q, k_cache, positions, (out,) if merged else (m, l, acc))
    return out if merged else (m, l, acc)


@_trace.reporter
def _report(q, k_cache, positions, outs):
    """A split launch's work to the active traces: each row's live cache
    rows (position + 1, at most S) read once as K and V at 4 hq d FLOPs
    a row; q and the positions read, the outputs written."""
    hq, d = q.shape[1:]
    S, hkv = k_cache.shape[1:3]
    live = int(torch.clamp(positions.long() + 1, 0, S).sum())
    _trace.kernel("decode_attention", flops=4 * hq * d * live,
                  bytes_read=2 * live * hkv * d * k_cache.element_size()
                  + _trace.tensors_bytes(q, positions),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


@_trace.reporter
def _report_combine(m, l, acc, out):
    """A combine launch's work: each split's acc scaled and summed (m
    and l folded on the way), the summaries read, the output written."""
    _trace.kernel("combine_splits", flops=2 * acc.numel(),
                  bytes_read=_trace.tensors_bytes(m, l, acc),
                  bytes_written=_trace.tensors_bytes(out), outputs=(out,))


def decode_partials(q, k_cache, v_cache, positions, *, kv_splits=8):
    """q: (b, hq, d); k_cache/v_cache: (b, S, hkv, d) in q's dtype;
    positions: (b,) int32 inclusive newest index (at or past S: every
    row).  Returns the split summaries (m, l, acc) f32, as
    `decode_partials_plain` does."""
    if B.plain_device(q):
        return decode_partials_plain(q, k_cache, v_cache, positions,
                                     kv_splits=kv_splits)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k_cache, v_cache, positions, kv_splits, partials=True)


def combine_splits_kernel(m, l, acc, b: int, hq: int, d: int, out_dtype):
    """`combine_splits` on the card: the combine kernel over CUDA
    summaries m, l (b*hkv, splits, group) and acc (b*hkv, splits, group,
    d), f32 and contiguous.  Raises on what the kernel does not take."""
    if m.device.type != "cuda":
        raise ValueError(f"the combine kernel runs on cuda, not {m.device}")
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"out dtype {out_dtype}: the kernel writes float32 "
                         f"or bfloat16")
    if m.dim() != 3 or l.shape != m.shape or acc.shape != (*m.shape, d):
        raise ValueError("want m, l (b*hkv, splits, group) and acc "
                         "(b*hkv, splits, group, d)")
    bh, splits, g = m.shape
    if bh * g != b * hq:
        raise ValueError(f"{bh} x {g} summaries do not make ({b}, {hq}) "
                         f"query rows")
    for name, t in (("m", m), ("l", l), ("acc", acc)):
        if t.dtype != torch.float32 or t.device != m.device:
            raise ValueError(f"{name} must be float32 on {m.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 4 * (splits + 1) * g > MAX_SMEM:
        raise ValueError(f"{splits} splits x group {g} exceed the combine "
                         f"kernel's shared memory")
    out = torch.empty((b, hq, d), dtype=out_dtype, device=m.device)
    lib = B.library().lib
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = lib.repro_combine_splits(
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), bh, g,
            d, splits, DTYPE_CODES[out_dtype], stream)
    B.check(err, "combine_splits")
    COMBINE.launches += 1
    _report_combine(m, l, acc, out)
    return out


def decode_attention(q, k_cache, v_cache, positions, *, kv_splits=8):
    """`decode_partials` merged by `combine_splits`: (b, hq, d) in q's
    dtype.  On a CUDA tensor bf16 is one launch of the tensor-core
    kernel, f32 the split kernel then the combine kernel (`route`)."""
    b, hq, d = q.shape
    if q.device.type == "cuda" and route(q.dtype) == TENSOR_CORES:
        return _launch(q, k_cache, v_cache, positions, kv_splits,
                       partials=False)
    m, l, acc = decode_partials(q, k_cache, v_cache, positions,
                                kv_splits=kv_splits)
    if B.plain_device(q):
        return combine_splits(m, l, acc, b, hq, d, q.dtype)
    return combine_splits_kernel(m, l, acc, b, hq, d, q.dtype)
