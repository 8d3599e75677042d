"""Paged decode attention: the Hopper kernel's wrapper and its plain
PyTorch version.

Port of `repro.kernels.paged_attention` (TPU kernel
`paged_decode_attention_pallas`, kernel.py:245).  One decode query per
batch row attends over ONE layer's (P, page, hkv, d) page arena through
a (b, max_pages) block table — pages stay resident in their arena
slots, only the query and the (b, hq, d) output travel.

* `paged_decode_attention` — the entry point.  A CUDA tensor launches
  the hand-written kernel (`kernels/csrc/paged_attention.cu`) or raises
  on a device, dtype, shape or layout it does not take; a CPU tensor
  takes the plain version.  There is no fallback between the two.
  `launches` counts kernel launches.
* `paged_decode_attention_plain` — gather plus masked f32 softmax,
  written from the reference oracle `ref.paged_decode_attention_ref`.
  Scores are computed in f32 from f32 casts of q and K (the oracle
  rounds them through q's dtype first); the output is in q's dtype.

The kernel keeps p in f32 for the PV product (the TPU kernel rounds p
to V's dtype first), so in bf16 it differs from the plain version by
bf16 rounding of p and of the output; `chip_smoke.py` states the
tolerance it holds each dtype to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B

NEG_INF = -1e30

# page-position sentinel for padded / non-resident block-table slots: far
# past any real position, with headroom so sentinel + page_size never
# overflows int32
POS_PAD = 2 ** 30

# kernel launches since import (reset by callers that count a run)
launches = 0

# element-type codes of the C interface (kernels/csrc/paged_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

# kernel geometry limits (paged_common.cuh)
THREADS = 128
MAX_ROW_ELEMS = THREADS * 32
TILE_TOKENS = 64
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256


def default_page_positions(block_table, page_size: int):
    """(b, max_pages) absolute first-token position of each table slot
    for the dense (unsharded) walk: slot i holds logical page i."""
    b, mp = block_table.shape
    pos = torch.arange(mp, dtype=torch.int32,
                       device=block_table.device) * page_size
    return pos[None, :].expand(b, mp)


def _gather_kv(k_pages, v_pages, block_table, k_scale, v_scale):
    """(b, max_pages*page, hkv, d) gathered K/V, dequantized to f32 when
    the arena carries scales."""
    b, mp = block_table.shape
    page, hkv, d = k_pages.shape[1:]
    bt = block_table.long()
    k = k_pages[bt].reshape(b, mp * page, hkv, d)
    v = v_pages[bt].reshape(b, mp * page, hkv, d)
    if k_scale is not None:
        k = k.float() * k_scale[bt].reshape(b, mp * page, hkv)[..., None]
        v = v.float() * v_scale[bt].reshape(b, mp * page, hkv)[..., None]
    return k, v


def _kv_positions(block_table, page_positions, page: int):
    b, mp = block_table.shape
    if page_positions is None:
        page_positions = default_page_positions(block_table, page)
    within = torch.arange(page, dtype=torch.int32, device=block_table.device)
    return (page_positions[:, :, None] + within[None, None, :]).reshape(
        b, mp * page)


def paged_decode_attention_plain(q, k_pages, v_pages, block_table, positions,
                                 page_positions=None, partials=False,
                                 k_scale=None, v_scale=None):
    """q: (b, hq, d); k_pages/v_pages: (P, page, hkv, d) one layer's
    arena; block_table: (b, max_pages) int; positions: (b,) inclusive
    newest index.  Returns (b, hq, d) in q's dtype, or with `partials`
    the unnormalized summary (m (b, hq), l (b, hq), acc (b, hq, d)) f32."""
    b, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    k, v = _gather_kv(k_pages, v_pages, block_table, k_scale, v_scale)
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    kv_pos = _kv_positions(block_table, page_positions, page)
    mask = (kv_pos <= positions[:, None])[:, None, None, :]      # (b,1,1,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if partials:
        # explicit masked accumulation: fully-masked rows keep l == 0 and
        # acc == 0 (softmax would emit exp(0) per masked entry)
        m = s.amax(dim=-1)
        p = torch.where(mask, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
        return m.reshape(b, hq), p.sum(-1).reshape(b, hq), acc.reshape(b, hq, d)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)


# ----------------------------------------------------------- the kernel

def smem_bytes(rows: int, d: int, page: int) -> int:
    """Dynamic shared memory of one block (paged_common.cuh smem_bytes)."""
    tp = 1 if page >= TILE_TOKENS else TILE_TOKENS // page
    t = tp * page
    return 4 * (rows * (d + 1) + t * (d + 1) + t * d + rows * t + 5 * rows
                + 2 * tp)


def check_kernel_inputs(q, k_pages, v_pages, index_tensors, k_scale, v_scale,
                        rows: int):
    """Raise ValueError on anything the CUDA kernels do not take.
    Returns the (q, kv) element-type codes."""
    dev = q.device
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages, **index_tensors}
    if k_scale is not None or v_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t is None:
            raise ValueError(f"{name} is required with a quantized arena")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index_tensors.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    kv_dtype = k_pages.dtype
    if v_pages.dtype != kv_dtype:
        raise ValueError("k_pages and v_pages differ in dtype")
    quant = kv_dtype in QUANT_DTYPES
    if not quant and kv_dtype != q.dtype:
        raise ValueError(f"pages {kv_dtype} must match q {q.dtype} or be "
                         f"int8/float8_e4m3fn")
    if quant != (k_scale is not None):
        raise ValueError("k_scale/v_scale go with int8/fp8 pages, and only "
                         "with them")
    P, page, hkv, d = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if quant:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or tuple(t.shape) != (P, page, hkv):
                raise ValueError(f"scales must be float32 {(P, page, hkv)}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if rows * d > MAX_ROW_ELEMS or rows > THREADS:
        raise ValueError(f"{rows} query rows x head_dim {d} exceed one "
                         f"block's {MAX_ROW_ELEMS} accumulators")
    if smem_bytes(rows, d, page) > MAX_SMEM:
        raise ValueError(f"page {page} x head_dim {d} needs more shared "
                         f"memory than a block has")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return DTYPE_CODES[q.dtype], DTYPE_CODES[kv_dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_decode(q, k_pages, v_pages, block_table, positions,
                   page_positions, partials, k_scale, v_scale):
    global launches
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    index = {"block_table": block_table, "positions": positions}
    if page_positions is not None:
        index["page_positions"] = page_positions
    qc, kc = check_kernel_inputs(q, k_pages, v_pages, index, k_scale,
                                 v_scale, rows=hq // hkv)
    mp = block_table.shape[1]
    if tuple(block_table.shape) != (b, mp) or tuple(positions.shape) != (b,):
        raise ValueError("block_table must be (b, max_pages), positions (b,)")
    if page_positions is not None and page_positions.shape != block_table.shape:
        raise ValueError("page_positions must match block_table's shape")
    dev = q.device
    if partials:
        out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, hq), dtype=torch.float32, device=dev)
        l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    else:
        out = torch.empty_like(q)
        m = l = None
    lib = B.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_paged_decode(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale),
            _ptr(v_scale), _ptr(block_table), _ptr(positions),
            _ptr(page_positions), _ptr(out), _ptr(m), _ptr(l),
            b, hq, hkv, d, k_pages.shape[1], mp, qc, kc, int(partials),
            stream)
    B.check(err, "paged_decode_attention")
    launches += 1
    return (m, l, out) if partials else out


def paged_decode_attention(q, k_pages, v_pages, block_table, positions, *,
                           page_positions=None, partials=False,
                           k_scale=None, v_scale=None):
    """q: (b, hq, d); k_pages/v_pages: (P, page, hkv, d) one layer's
    arena; block_table: (b, max_pages) int32 physical page ids (entries
    past the sequence may be any valid slot, e.g. the null page);
    positions: (b,) int32 inclusive newest index.

    `page_positions` ((b, max_pages) int32) gives each table slot's
    absolute first-token position (default slot i == logical page i;
    POS_PAD marks holes).  `partials=True` returns the online-softmax
    carry (m (b, hq), l (b, hq), acc (b, hq, d)) f32 instead of the
    normalized output.  `k_scale`/`v_scale` ((P, page, hkv) f32) are a
    quantized (int8/fp8) arena's per-token scales, dequantized inside
    the page walk.  Returns (b, hq, d) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_table, positions,
            page_positions=page_positions, partials=partials,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_decode(q, k_pages, v_pages, block_table, positions,
                          page_positions, partials, k_scale, v_scale)
