"""Paged chunk-prefill attention: the Hopper kernel's wrapper and its
plain PyTorch version.

Port of `repro.kernels.paged_prefill` (TPU kernel
`paged_prefill_attention_pallas`, kernel.py:90).  A ragged (b, c)
prompt chunk attends causally over everything already written into each
row's pages (its own K/V included), through the same block-table walk
as decode; rows past `chunk_len` are exact zeros.

* `paged_prefill_attention` — a CUDA tensor launches the hand-written
  kernel (`kernels/csrc/paged_prefill.cu`) or raises; a CPU tensor takes
  the plain version.  `launches` counts kernel launches.
* `paged_prefill_attention_plain` — gather plus masked f32 softmax,
  written from `ref.paged_prefill_attention_ref` (scores in f32, output
  in q's dtype; see `kernels/paged_attention/ops.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.paged_attention.ops import (
    MAX_ROW_ELEMS, NEG_INF, _gather_kv, _kv_positions, _ptr,
    check_kernel_inputs)

# kernel launches since import (reset by callers that count a run)
launches = 0

# packed query rows per block: up to 64, and rows x head_dim within the
# block's register accumulators
MAX_TILE_ROWS = 64


def paged_prefill_attention_plain(q, k_pages, v_pages, block_table, start,
                                  chunk_len, page_positions=None,
                                  partials=False, k_scale=None, v_scale=None):
    """q: (b, c, hq, d) chunk queries at absolute positions
    start[i]..start[i]+c-1; k_pages/v_pages: (P, page, hkv, d) one
    layer's arena; block_table: (b, max_pages); chunk_len: (b,) valid
    rows.  Returns (b, c, hq, d) in q's dtype, or with `partials`
    (m (b, c, hq), l (b, c, hq), acc (b, c, hq, d)) f32."""
    b, c, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    k, v = _gather_kv(k_pages, v_pages, block_table, k_scale, v_scale)
    rows = torch.arange(c, dtype=torch.int32, device=q.device)
    positions = start[:, None] + rows[None, :]                    # (b, c)
    qg = q.reshape(b, c, hkv, g, d).float()
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k.float()) / math.sqrt(d)
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
    """Packed (chunk position, group member) rows one block takes."""
    return max(1, min(c * group, MAX_TILE_ROWS, MAX_ROW_ELEMS // d))


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
    rpt = rows_per_tile(c, hq // hkv, d)
    qc, kc = check_kernel_inputs(q, k_pages, v_pages, index, k_scale,
                                 v_scale, rows=rpt)
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
    return (m, l, out) if partials else out


def paged_prefill_attention(q, k_pages, v_pages, block_table, start,
                            chunk_len, *, page_positions=None, partials=False,
                            k_scale=None, v_scale=None):
    """q: (b, c, hq, d) chunk queries; k_pages/v_pages: (P, page, hkv, d)
    one layer's arena (the chunk's own K/V already written);
    block_table: (b, max_pages) int32; start/chunk_len: (b,) int32
    chunk geometry.  Returns (b, c, hq, d) in q's dtype; rows past
    chunk_len are exact zeros.  `page_positions`, `partials`,
    `k_scale`/`v_scale` as in `paged_decode_attention` (partials:
    m (b, c, hq), l (b, c, hq), acc (b, c, hq, d) f32)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, block_table, start, chunk_len,
            page_positions=page_positions, partials=partials,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_prefill(q, k_pages, v_pages, block_table, start, chunk_len,
                           page_positions, partials, k_scale, v_scale)
