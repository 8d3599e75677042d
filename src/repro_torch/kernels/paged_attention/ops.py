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
  takes the plain version with the reference's score rounding
  (`round_scores`).  There is no fallback between the two.
  `launches` counts kernel launches.
* `paged_decode_attention_plain` — gather plus masked f32 softmax,
  written from the reference oracle `ref.paged_decode_attention_ref`.
  Scores are computed in f32 from f32 casts of q and K; the oracle
  rounds them through q's dtype first, which `round_scores` copies (the
  CPU model's route); the output is in q's dtype.
* `paged_decode_attention_splits_plain` — the bf16 kernel's arithmetic
  in plain PyTorch: per-split (m, l, acc) over whole-page splits of the
  table, merged by log-sum-exp (or, with `partials`, left as the merged
  raw carry).

The kernel has two designs, fixed by the (q, pages) dtype pair
(`route`); neither falls back to the other:

* bf16 q with bf16 pages, what every served configuration runs: one
  launch of a tensor-core kernel split over the KV length.  Block
  (batch row x kv head, split) walks `split_pages(page)` whole pages
  (128 tokens, or one page when a page is longer) through a 2-stage
  cp.async ring of 64-token bf16 tiles; the query group (at most
  TC_GROUP_ROWS rows) is one m16 tile of mma.sync products; p is
  rounded to bf16 before the PV product, as the TPU kernel rounds p to
  V's dtype.  The splits merge in the same launch: each writes its f32
  carry to the device's scratch and the last to arrive (an atomic
  ticket per batch row and kv head) merges them.  The number of splits
  comes from max_pages and the page size alone: the host never reads
  `positions`.  It takes head dims that are multiples of 16 up to 256
  and raises on others.
* f32 q, or int8 / fp8 pages: the CUDA-core machine shared with paged
  prefill (f32 scores and p, from shared memory, one block per batch
  row and kv head).  It keeps p in f32 for the PV product, except with
  bf16 pages under f32 q (an f32 model over a bf16 arena): there it
  takes the plain version's rounding (the normalised p and the output
  rounded to bf16), walking the table twice, once for each row's
  (m, l) and once to accumulate.

In bf16 each design thus differs from the plain version by bf16
rounding of p or of the output; `kernels/tolerance.py` states the
tolerance each dtype is held to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.launch import trace as _trace

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

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"

# the bf16 tensor-core decode design's geometry (paged_attention.cu
# namespace dec_tc; paged_tc.cuh)
TC_GROUP_ROWS = 16     # query group rows per block: one m16 tile
TC_WARPS = 4           # each takes 16 tokens of a tile
TC_TILE_TOKENS = 64    # kv tokens per tile
TC_STAGES = 2          # K/V tiles in flight (cp.async ring)
TC_META_SLOTS = 3      # per-token (arena row, position) ring, one tile ahead
TC_PAD = 8             # bf16 elements of shared-memory row padding
SPLIT_TOKENS = 128     # kv tokens per split, in whole pages

# the device's split scratch and merge counters (`_scratch`)
_SCRATCH: dict = {}


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
                                 k_scale=None, v_scale=None,
                                 round_scores=False):
    """q: (b, hq, d); k_pages/v_pages: (P, page, hkv, d) one layer's
    arena; block_table: (b, max_pages) int; positions: (b,) inclusive
    newest index.  Returns (b, hq, d) in q's dtype, or with `partials`
    the unnormalized summary (m (b, hq), l (b, hq), acc (b, hq, d)) f32.
    `round_scores` rounds q.k to the product's dtype (q's against
    unquantized pages) before the f32 scale, as the reference's oracle
    does (paged_attention/ref.py); off, the scores stay f32 (the CUDA
    kernels' oracle)."""
    b, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    k, v = _gather_kv(k_pages, v_pages, block_table, k_scale, v_scale)
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    if round_scores:
        s = s.to(torch.promote_types(q.dtype, k.dtype)).float()
    s = s / math.sqrt(d)
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


def split_pages(page: int) -> int:
    """Table columns per split of the bf16 design: SPLIT_TOKENS worth of
    whole pages, at least one."""
    return max(1, SPLIT_TOKENS // page)


def num_splits(max_pages: int, page: int) -> int:
    """Splits of a (b, max_pages) table: what the host knows, never the
    positions."""
    return -(-max_pages // split_pages(page))


def paged_decode_attention_splits_plain(q, k_pages, v_pages, block_table,
                                        positions, page_positions=None,
                                        partials=False, pages_per_split=None):
    """The bf16 kernel's arithmetic: the table cut into splits of
    `pages_per_split` whole pages (default `split_pages(page)`), each
    reduced to an f32 carry (m, l, acc) with p rounded to V's dtype for
    the PV product (exact in f32), an empty split's carry (m = -1e30,
    l = 0, acc = 0) weighted 0; the splits merged by log-sum-exp.
    Returns (b, hq, d) in q's dtype, or with `partials` the merged raw
    carry (m (b, hq), l (b, hq), acc (b, hq, d)) f32."""
    b, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = block_table.shape[1]
    g = hq // hkv
    pps = pages_per_split or split_pages(page)
    n = -(-mp // pps)
    k, v = _gather_kv(k_pages, v_pages, block_table, None, None)
    kv_pos = _kv_positions(block_table, page_positions, page)
    pad = n * pps * page - mp * page
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=POS_PAD)
    L = pps * page
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    mask = (kv_pos <= positions[:, None]).reshape(b, 1, 1, n, L)
    s = s.reshape(b, hkv, g, n, L)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                    # (b, hkv, g, n)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgnt,bnthd->bhgnd", p.to(v.dtype).float(),
                       v.reshape(b, n, L, hkv, d).float())
    # the merge: empty splits (l == 0) take weight 0
    m_tot = torch.where(l > 0, m, torch.full_like(m, NEG_INF)).amax(-1)
    w = torch.where(l > 0, torch.exp(m - m_tot[..., None]),
                    torch.zeros_like(m))
    l_tot = (l * w).sum(-1)
    acc_tot = (acc * w[..., None]).sum(-2)                # (b, hkv, g, d)
    if partials:
        return (m_tot.reshape(b, hq), l_tot.reshape(b, hq),
                acc_tot.reshape(b, hq, d))
    o = acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return o.reshape(b, hq, d).to(q.dtype)


# ----------------------------------------------------------- the kernel

def route(q_dtype, kv_dtype) -> str:
    """Which design takes a (q, pages) dtype pair: bf16 with bf16 on
    tensor cores, every other pair the kernel takes on CUDA cores."""
    if q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16:
        return TENSOR_CORES
    return CUDA_CORES


def smem_bytes(rows: int, d: int, page: int) -> int:
    """Dynamic shared memory of one block (paged_common.cuh smem_bytes)."""
    tp = 1 if page >= TILE_TOKENS else TILE_TOKENS // page
    t = tp * page
    return 4 * (rows * (d + 1) + t * (d + 1) + t * d + rows * t + 5 * rows
                + 2 * tp)


def check_kernel_inputs(q, k_pages, v_pages, index_tensors, k_scale, v_scale):
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
    # an f32 model may store its pages in bf16 (`kv_dtype="bf16"`)
    if not quant and kv_dtype != q.dtype and not (
            q.dtype == torch.float32 and kv_dtype == torch.bfloat16):
        raise ValueError(f"pages {kv_dtype} must match q {q.dtype}, be "
                         f"bfloat16 under float32 q, or be "
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
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return DTYPE_CODES[q.dtype], DTYPE_CODES[kv_dtype]


def check_row_tile(rows: int, d: int, page: int) -> None:
    """Raise ValueError on a block of `rows` query rows that the CUDA-core
    machine (paged_common.cuh attend_rows) cannot hold at this head dim
    and page size."""
    if rows * d > MAX_ROW_ELEMS or rows > THREADS:
        raise ValueError(f"{rows} query rows x head_dim {d} exceed one "
                         f"block's {MAX_ROW_ELEMS} accumulators")
    if smem_bytes(rows, d, page) > MAX_SMEM:
        raise ValueError(f"page {page} x head_dim {d} needs more shared "
                         f"memory than a block has")


def tc_smem_bytes(d: int, splits: int) -> int:
    """Dynamic shared memory of one tensor-core decode block
    (paged_attention.cu `dec_tc::smem_bytes`): Q in bf16 at row stride
    d + 8; the K/V ring, whose space the merges take after the walk (the
    warps' f32 O, m, l and weights, the block's m and l; then the
    splits' m and l and the merged m and l); the meta ring's int32 rows
    and positions."""
    rows, warps = TC_GROUP_ROWS, TC_WARPS
    ring = 2 * 2 * TC_STAGES * TC_TILE_TOKENS * (d + TC_PAD)
    merge = 4 * max(warps * rows * (d + 3) + 2 * rows,
                    (2 * splits + 2) * rows)
    return (2 * rows * (d + TC_PAD) + max(ring, merge)
            + 4 * 2 * TC_META_SLOTS * TC_TILE_TOKENS)


def check_tc_geometry(k_pages, group: int, splits: int) -> None:
    """Raise ValueError on a bf16 call the tensor-core decode design does
    not take: head dims that are not multiples of 16 (check_kernel_inputs
    caps them at 256), query groups past one m16 tile, more splits than
    one block's shared memory merges, and token rows past int32
    indexing."""
    P, page, hkv, d = k_pages.shape
    if d % 16:
        raise ValueError(f"head_dim {d}: the bf16 decode kernel takes "
                         f"multiples of 16 up to 256")
    if group > TC_GROUP_ROWS:
        raise ValueError(f"query group {group}: the bf16 decode kernel "
                         f"takes at most {TC_GROUP_ROWS} rows per kv head")
    if tc_smem_bytes(d, splits) > MAX_SMEM:
        raise ValueError(f"{splits} splits need more shared memory to "
                         f"merge than a block has")
    if P * page * hkv >= 2 ** 31:
        raise ValueError("the arena has too many token rows for int32 "
                         "indexing")


def _scratch(dev, floats: int, rows: int):
    """The device's split scratch (`floats` f32) and merge counters
    (`rows` int32, 0 between calls: the kernel's last split resets its
    own), grown as needed and never cleared per call.  Two calls in
    flight on two streams would share them; the port runs one stream."""
    part, tickets = _SCRATCH.get(dev, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < rows:
        tickets = torch.zeros(rows, dtype=torch.int32, device=dev)
    _SCRATCH[dev] = (part, tickets)
    return part, tickets


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
                                 v_scale)
    page, mp = k_pages.shape[1], block_table.shape[1]
    tensor_cores = route(q.dtype, k_pages.dtype) == TENSOR_CORES
    if tensor_cores:
        pps = split_pages(page)
        check_tc_geometry(k_pages, hq // hkv, num_splits(mp, page))
    else:
        pps = 0    # the CUDA-core design walks the whole table per block
        check_row_tile(hq // hkv, d, page)
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
    part = tickets = None
    if tensor_cores:
        part, tickets = _scratch(dev, (2 + d) * b * hq * num_splits(mp, page),
                                 b * hkv)
    lib = B.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_paged_decode(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale),
            _ptr(v_scale), _ptr(block_table), _ptr(positions),
            _ptr(page_positions), _ptr(out), _ptr(m), _ptr(l), _ptr(part),
            _ptr(tickets), b, hq, hkv, d, page, mp, pps, qc, kc,
            int(partials), stream)
    B.check(err, "paged_decode_attention")
    launches += 1
    _report_decode(q, k_pages, block_table, positions, k_scale,
                   (m, l, out) if partials else (out,))
    return (m, l, out) if partials else out


@_trace.reporter
def _report_decode(q, k_pages, block_table, positions, k_scale, outs):
    """The launch's work to the active traces: each row's live tokens
    (its position + 1, at most the table's width) read once as K and V
    (and their scales), 4 hq d FLOPs a token; q, the walked table
    entries and the positions read, the outputs written."""
    b, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = block_table.shape[1]
    live = torch.clamp(positions.long() + 1, 0, mp * page)
    n = int(live.sum())
    pages = int(((live + page - 1) // page).sum())
    kv = n * hkv * (d * k_pages.element_size()
                    + (4 if k_scale is not None else 0))
    _trace.kernel("paged_decode_attention", flops=4 * hq * d * n,
                  bytes_read=2 * kv + _trace.tensors_bytes(q, positions)
                  + 4 * pages,
                  bytes_written=_trace.tensors_bytes(*outs), outputs=outs)


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
    the page walk.  Returns (b, hq, d) in q's dtype.  On a CUDA tensor,
    bf16 q with bf16 pages takes the tensor-core design (one launch,
    split over the KV length; head dims multiples of 16 up to 256, query
    groups up to 16), every other pair the CUDA-core one (`route`)."""
    if B.plain_device(q):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_table, positions,
            page_positions=page_positions, partials=partials,
            k_scale=k_scale, v_scale=v_scale, round_scores=True)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_decode(q, k_pages, v_pages, block_table, positions,
                          page_positions, partials, k_scale, v_scale)
