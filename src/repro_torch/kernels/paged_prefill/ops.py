"""Paged chunk-prefill attention: the Hopper kernel's wrapper and its
plain PyTorch version.

Port of `repro.kernels.paged_prefill` (TPU kernel
`paged_prefill_attention_pallas`, kernel.py:90).  A ragged (b, c)
prompt chunk attends causally over everything already written into each
row's pages (its own K/V included), through the same block-table walk
as decode; rows past `chunk_len` are exact zeros.

* `paged_prefill_attention` — a CUDA tensor launches the hand-written
  kernel (`kernels/csrc/paged_prefill.cu`) or raises; a CPU tensor takes
  the plain version with the reference's score rounding
  (`round_scores`).  `launches` counts kernel launches.
* `paged_prefill_attention_plain` — gather plus masked f32 softmax,
  written from `ref.paged_prefill_attention_ref` (scores in f32, output
  in q's dtype; see `kernels/paged_attention/ops.py`).

The kernel has two designs, fixed by the (q, pages) dtype pair
(`route`); neither falls back to the other:

* bf16 q with bf16 pages, what every served configuration runs: a
  flash-style tensor-core kernel (mma.sync bf16 -> f32, 64 packed rows
  per block, 64-token KV tiles through a 2-stage cp.async ring, the
  online softmax and the O accumulator in registers).  p is rounded to
  bf16 before the PV product, as the TPU kernel rounds p to V's dtype,
  also under `partials` (where the plain version keeps p in f32).  It
  takes head dims that are multiples of 16 up to 256 and raises on
  others.
* f32 q, or int8 / fp8 pages: the CUDA-core machine shared with paged
  decode (f32 scores and p, from shared memory).  f32 stays off the
  tensor cores because there it would be TF32, which the port never
  uses; quantized pages are dequantised to f32 as they land.  bf16
  pages under f32 q take the plain version's rounding in two walks
  (`kernels/paged_attention/ops.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace
from repro_torch.kernels.paged_attention.ops import (
    CUDA_CORES, MAX_ROW_ELEMS, NEG_INF, TENSOR_CORES, _gather_kv,
    _kv_positions, _ptr, check_kernel_inputs, check_row_tile, route)

# kernel launches since import (reset by callers that count a run)
launches = 0

# packed query rows per block: up to 64, and rows x head_dim within the
# block's register accumulators
MAX_TILE_ROWS = 64

# the tensor-core design's geometry (paged_prefill.cu namespace tc)
TC_ROWS = 64           # packed query rows per block, 16 per warp
TC_TILE_TOKENS = 64    # kv tokens per tile
TC_STAGES = 2          # K/V tiles in flight (cp.async ring)
TC_META_SLOTS = 3      # per-token (arena row, position) ring, one tile ahead
TC_PAD = 8             # bf16 elements of shared-memory row padding
# shared memory of one SM, and what the card reserves per resident block
SM_SMEM = 233_472
BLOCK_RESERVED_SMEM = 1_024


def paged_prefill_attention_plain(q, k_pages, v_pages, block_table, start,
                                  chunk_len, page_positions=None,
                                  partials=False, k_scale=None, v_scale=None,
                                  round_scores=False):
    """q: (b, c, hq, d) chunk queries at absolute positions
    start[i]..start[i]+c-1; k_pages/v_pages: (P, page, hkv, d) one
    layer's arena; block_table: (b, max_pages); chunk_len: (b,) valid
    rows.  Returns (b, c, hq, d) in q's dtype, or with `partials`
    (m (b, c, hq), l (b, c, hq), acc (b, c, hq, d)) f32.
    `round_scores` rounds q.k to the product's dtype (q's against
    unquantized pages) before the f32 scale, as the reference's oracle
    does (paged_prefill/ref.py); off, the scores stay f32 (the CUDA
    kernels' oracle)."""
    b, c, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    k, v = _gather_kv(k_pages, v_pages, block_table, k_scale, v_scale)
    rows = torch.arange(c, dtype=torch.int32, device=q.device)
    positions = start[:, None] + rows[None, :]                    # (b, c)
    qg = q.reshape(b, c, hkv, g, d).float()
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k.float())
    if round_scores:
        s = s.to(torch.promote_types(q.dtype, k.dtype)).float()
    s = s / math.sqrt(d)
    kv_pos = _kv_positions(block_table, page_positions, page)
    mask = kv_pos[:, None, :] <= positions[:, :, None]            # (b, c, S)
    q_valid = rows[None, :] < chunk_len[:, None]                  # (b, c)
    if partials:
        mask = (mask & q_valid[:, :, None])[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)                                        # (b,hkv,g,c)
        p = torch.where(mask, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        acc = torch.einsum("bhgcs,bshd->bchgd", p, v.float()).reshape(
            b, c, hq, d)

        def to_bch(x):
            return x.permute(0, 3, 1, 2).reshape(b, c, hq)
        return to_bch(m), to_bch(p.sum(-1)), acc
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgcs,bshd->bchgd", p, v).reshape(b, c, hq, d)
    o = torch.where(q_valid[..., None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def rows_per_tile(c: int, group: int, d: int) -> int:
    """Packed (chunk position, group member) rows one block of the
    CUDA-core design takes (the tensor-core design takes TC_ROWS)."""
    return max(1, min(c * group, MAX_TILE_ROWS, MAX_ROW_ELEMS // d))


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core block
    (paged_prefill.cu `tc::smem_bytes`): Q and the K/V ring in bf16 at
    row stride d + 8, then the meta ring's int32 rows and positions."""
    return (2 * (1 + 2 * TC_STAGES) * TC_ROWS * (d + TC_PAD)
            + 4 * 2 * TC_META_SLOTS * TC_TILE_TOKENS)


def tc_blocks_per_sm(d: int) -> int:
    """Tensor-core blocks resident on one SM, as shared memory allows."""
    return SM_SMEM // (tc_smem_bytes(d) + BLOCK_RESERVED_SMEM)


def check_tc_geometry(k_pages) -> None:
    """Raise ValueError on a bf16 arena the tensor-core design does not
    take: head dims that are not multiples of 16 (check_kernel_inputs
    caps them at 256), and token rows past int32 indexing."""
    P, page, hkv, d = k_pages.shape
    if d % 16:
        raise ValueError(f"head_dim {d}: the bf16 prefill kernel takes "
                         f"multiples of 16 up to 256")
    if P * page * hkv >= 2 ** 31:
        raise ValueError("the arena has too many token rows for int32 "
                         "indexing")


def _launch_prefill(q, k_pages, v_pages, block_table, start, chunk_len,
                    page_positions, partials, k_scale, v_scale):
    global launches
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    index = {"block_table": block_table, "start": start,
             "chunk_len": chunk_len}
    if page_positions is not None:
        index["page_positions"] = page_positions
    qc, kc = check_kernel_inputs(q, k_pages, v_pages, index, k_scale,
                                 v_scale)
    if route(q.dtype, k_pages.dtype) == TENSOR_CORES:
        check_tc_geometry(k_pages)
        rpt = 0    # the tensor-core design's tile is fixed in the kernel
    else:
        rpt = rows_per_tile(c, hq // hkv, d)
        check_row_tile(rpt, d, k_pages.shape[1])
    mp = block_table.shape[1]
    if (tuple(block_table.shape) != (b, mp) or tuple(start.shape) != (b,)
            or tuple(chunk_len.shape) != (b,)):
        raise ValueError("block_table must be (b, max_pages), start and "
                         "chunk_len (b,)")
    if page_positions is not None and page_positions.shape != block_table.shape:
        raise ValueError("page_positions must match block_table's shape")
    dev = q.device
    if partials:
        out = torch.empty((b, c, hq, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, c, hq), dtype=torch.float32, device=dev)
        l = torch.empty((b, c, hq), dtype=torch.float32, device=dev)
    else:
        out = torch.empty_like(q)
        m = l = None
    lib = B.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_paged_prefill(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale),
            _ptr(v_scale), _ptr(block_table), _ptr(start), _ptr(chunk_len),
            _ptr(page_positions), _ptr(out), _ptr(m), _ptr(l),
            b, c, hq, hkv, d, k_pages.shape[1], mp, rpt, qc, kc,
            int(partials), stream)
    B.check(err, "paged_prefill_attention")
    launches += 1
    _report_prefill(q, k_pages, start, chunk_len, k_scale,
                    (m, l, out) if partials else (out,))
    return (m, l, out) if partials else out


@_trace.reporter
def _report_prefill(q, k_pages, start, chunk_len, k_scale, outs):
    """The launch's work to the active traces: each row's visible
    (query, key) pairs at 4 hq d FLOPs a pair; the K/V tokens up to
    start + chunk_len read once (and their scales), q and the walked
    table entries read, the outputs written."""
    b, c, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    st, cl = start.long().cpu(), chunk_len.long().cpu()
    need = torch.where(cl > 0, st + cl, torch.zeros_like(st))
    pairs = int((st * cl + cl * (cl + 1) // 2).sum())
    n = int(need.sum())
    kv = n * hkv * (d * k_pages.element_size()
                    + (4 if k_scale is not None else 0))
    _trace.kernel("paged_prefill_attention", flops=4 * hq * d * pairs,
                  bytes_read=2 * kv + _trace.tensors_bytes(q, start,
                                                           chunk_len)
                  + 4 * int(((need + page - 1) // page).sum()),
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


def paged_prefill_attention(q, k_pages, v_pages, block_table, start,
                            chunk_len, *, page_positions=None, partials=False,
                            k_scale=None, v_scale=None):
    """q: (b, c, hq, d) chunk queries; k_pages/v_pages: (P, page, hkv, d)
    one layer's arena (the chunk's own K/V already written);
    block_table: (b, max_pages) int32; start/chunk_len: (b,) int32
    chunk geometry.  Returns (b, c, hq, d) in q's dtype; rows past
    chunk_len are exact zeros.  `page_positions`, `partials`,
    `k_scale`/`v_scale` as in `paged_decode_attention` (partials:
    m (b, c, hq), l (b, c, hq), acc (b, c, hq, d) f32).  On a CUDA
    tensor, bf16 q with bf16 pages takes the tensor-core design (head
    dims multiples of 16 up to 256), every other pair the CUDA-core
    one (`route`)."""
    if B.plain_device(q):
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, block_table, start, chunk_len,
            page_positions=page_positions, partials=partials,
            k_scale=k_scale, v_scale=v_scale, round_scores=True)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_prefill(q, k_pages, v_pages, block_table, start, chunk_len,
                           page_positions, partials, k_scale, v_scale)
