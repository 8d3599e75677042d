"""Shared building blocks: norms, rotary, GQA projections, MLPs,
embeddings, the attention dispatch (contiguous and paged) and the LM
losses.

Port of `repro.models.layers`.  Plain functions on tensors with the
reference's names and parameter layouts: weights are (d_in, d_out), so
`x @ w` is the reference's product (`matmul`); each block's `*_axes`
gives the logical sharding axes of its parameters.  The sharded arena's
walk (`cfg.mem_axis`) is here.

Tensor parallelism over the mesh's "model" axis (the sharded train step,
`train/train_step.py`): a weight the step keeps as this rank's slice is
tagged with its model-axis group (`collectives.mark_tp`), and the blocks
below read the tag.  Attention then projects this rank's query heads
(columns of wq, wk, wv; kv heads replicated where there are fewer than
ranks), runs the flash kernel over them and multiplies by its rows of wo,
followed by one all-reduce of the activation; the MLP splits wg/wi by
column and wo by row the same way; the embedding lookup is
vocab-parallel (`_vocab_parallel_lookup`: a masked local gather and one
all-reduce; the table's gradient a local scatter-add), and so are the
head and the loss (`_vocab_parallel_ce_sum`: the softmax's max and sum
all-reduced, the (b, s, vocab) logits never gathered).  Untagged
weights compute as on one device.

Attention over contiguous K/V (`run_attention`, `run_decode_attention`)
launches the flash and split-KV decode kernels for CUDA tensors,
whatever `cfg.attention_impl` says; for CPU tensors it follows
`attention_impl` as the reference does: `"dense"` and `"flash_xla"` take
the ported XLA paths below, `"flash_pallas"` the kernels' plain
versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import current_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention.ops import (POS_PAD,
                                                     paged_decode_attention)
from repro_torch.kernels.paged_prefill.ops import paged_prefill_attention


def generator(device) -> torch.Generator:
    """The seeded init's generator on `device`; on "meta" (shapes only,
    nothing allocated) a CPU generator, which meta draws ignore."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta" else device)


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, 1) drawn in f32, cast, then scaled — the reference's order.
    The scaling is in place: the same bits as `x.to(dtype) * std`
    without a third copy alive (nemotron-4-340b's 4.7 B-element head is
    18.9 GB in f32 and 9.4 GB in bf16)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.to(dtype).mul_(std)


def matmul(x, w):
    """A weight projection `x @ w` as the reference's XLA dot computes
    it.  On a CPU tensor in bf16 that is an f32 product rounded once to
    bf16: torch's CPU bf16 GEMM sums in another order and lands one ulp
    off in a few elements (ROADMAP C.4).  Otherwise `x @ w`: the card
    keeps its bf16 GEMM, and f32 is unchanged."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


# ----------------------------------------------------------------- RMSNorm

def rmsnorm_init(cfg: ModelConfig, device, dim: int | None = None):
    return torch.ones((dim or cfg.d_model,), dtype=cfg.params_dtype,
                      device=device)


def rmsnorm_axes():
    return ("norm",)


def rmsnorm_apply(scale, x, eps: float):
    """f32 math, result cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ------------------------------------------------------------------ rotary

def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Half-split rotation; angles in f32, cos/sin cast to x's
    dtype BEFORE the rotation (the reference's rule)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., seq, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)        # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------- attention block

def attention_init(gen, cfg: ModelConfig, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    return {
        "wq": _normal(gen, (d, qd), std, pd, device),
        "wk": _normal(gen, (d, kvd), std, pd, device),
        "wv": _normal(gen, (d, kvd), std, pd, device),
        "wo": _normal(gen, (qd, d), out_std, pd, device),
    }


def attention_axes():
    return {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }


def attention_qkv(p, cfg: ModelConfig, x, positions):
    """x: (b, s, d) -> q (b,s,hq,hd), k/v (b,s,hkv,hd) with rope applied."""
    b, s, _ = x.shape
    q = matmul(x, p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = matmul(x, p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = matmul(x, p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# --------------------------------------------------------------- attention

NEG_INF = -1e30


def _repeat_kv(kv, hq: int):
    """(b, s, hkv, d) -> (b, s, hq, d), each kv head repeated over its
    query group."""
    hkv = kv.shape[2]
    if hkv == hq:
        return kv
    return kv.repeat_interleave(hq // hkv, dim=2)


def dense_attention(q, k, v, *, causal: bool, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d).  One masked softmax
    (the reference's small-scale path)."""
    b, sq, hq, d = q.shape
    k, v = _repeat_kv(k, hq), _repeat_kv(v, hq)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def flash_xla_attention(q, k, v, *, causal: bool, chunk: int, q_offset=0):
    """Online-softmax attention, a loop over KV chunks (the reference's
    XLA scan; the flash kernel is its twin on the card)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:      # pad KV to a chunk multiple; padded slots are masked below
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv + pad, chunk):
        k_i = _repeat_kv(k[:, c0:c0 + chunk], hq)
        v_i = _repeat_kv(v[:, c0:c0 + chunk], hq)
        pos_i = torch.arange(c0, c0 + chunk, device=q.device)
        s = torch.einsum("bqhd,bshd->bhqs", q, k_i).float() * scale
        valid = (pos_i < skv)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= pos_i[None, :])
        if causal or pad:
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(v_i.dtype), v_i)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(1, 2).to(q.dtype)                          # (b,sq,hq,d)


def decode_attention(q, k_cache, v_cache, position):
    """Single-token decode: q (b, hq, d); caches (b, S, hkv, d);
    position: (b,) index of the newly written token (every row at or
    before it is visible).  Returns (b, hq * d)."""
    b, hq, d = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache).float() / math.sqrt(d)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= position.long()[:, None])                           # (b, S)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache)
    return o.reshape(b, hq * d)


def run_decode_attention(cfg: ModelConfig, q, k_cache, v_cache, position):
    """Decode attention over ONE layer's contiguous cache: the split-KV
    kernel on the card; on the CPU the XLA path above, or the kernel's
    plain version under `flash_pallas`.  Returns (b, hq * d)."""
    b, hq, d = q.shape
    if q.device.type == "cpu" and cfg.attention_impl != "flash_pallas":
        return decode_attention(q, k_cache, v_cache, position)
    return decode_ops.decode_attention(q, k_cache, v_cache,
                                       position).reshape(b, hq * d)


def run_attention(cfg: ModelConfig, q, k, v, *, q_offset=0):
    """Attention of contiguous q (b, sq, hq, d) over k, v (b, skv, hkv,
    d): the flash kernel on the card; on the CPU the path
    `cfg.attention_impl` names.  Returns (b, sq, hq, d).  When grad is
    enabled and an input requires grad, the kernel route goes through
    `FlashAttentionFn` (the forward kernel with its log-sum-exp, and the
    backward kernel), so the result carries its gradient."""
    if q.device.type == "cpu":
        if cfg.attention_impl == "dense":
            return dense_attention(q, k, v, causal=cfg.causal,
                                   q_offset=q_offset)
        if cfg.attention_impl == "flash_xla":
            return flash_xla_attention(q, k, v, causal=cfg.causal,
                                       chunk=cfg.attn_chunk,
                                       q_offset=q_offset)
        if cfg.attention_impl != "flash_pallas":
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_ops.FlashAttentionFn.apply(q, k, v, cfg.causal,
                                                q_offset)
    return flash_ops.flash_attention(q, k, v, causal=cfg.causal,
                                     q_offset=q_offset)


# ------------------------------------------------ the sharded arena walk
#
# Under `cfg.mem_axis` (the sharded serving step) the page leaves a hook
# hands to the functions below are TUPLES of per-bank tensors, bank s on
# its mesh device, and `block_table` carries GLOBAL pool page ids (pool
# page g lives in bank g // pps at local slot g % pps; each bank's last
# slot, pps, is its own null sink).  Each bank walks only its resident
# pages, in partials mode, and the summaries merge on the lead device
# (q's) through `distribution/collectives.py`.


def localize_block_table(cfg: ModelConfig, block_table, num_local_pages,
                         shard: int = 0):
    """GLOBAL pool page ids -> bank `shard`'s slots for page WRITES:
    entries the bank owns become its local slots, everything else (other
    banks' pages, the null sentinel) its local null sink
    (`num_local_pages`).  Identity when `cfg.mem_axis` is unset (one
    arena: the table already is physical).  `shard` is the reference's
    `axis_index` of the bank."""
    if cfg.mem_axis is None:
        return block_table
    pps = num_local_pages
    return torch.where(block_table // pps == shard, block_table % pps,
                       torch.full_like(block_table, pps)).to(torch.int32)


def _shard_local_walk(n: int, shard: int, block_table, page_size: int,
                      local_null: int):
    """Compact bank `shard`'s walk of a GLOBAL block table to its
    resident stride (DESIGN.md §2): logical page j of a sequence lives
    on bank (rot + j) % n, where rot is the sequence's rotation,
    recovered as the bank that owns its page 0 (`block_table[:, 0] //
    pps`); idle rows (all null) clamp to n and are masked below.  The
    columns bank `shard` walks for row i are j = shard - rot_i (mod n).

    block_table: (b, max_pages) GLOBAL ids.  Returns the (b,
    ceil(max_pages / n)) compacted LOCAL table and its absolute page
    positions (POS_PAD for null, foreign and absent slots, which the
    kernels' position mask kills)."""
    pps = local_null                       # bank size == local null slot
    b, mp = block_table.shape
    mp_loc = -(-mp // n)
    rot = torch.clamp(block_table[:, 0] // pps, max=n)
    col0 = torch.remainder(shard - rot, n).to(torch.int32)        # (b,)
    cols = col0[:, None] + n * torch.arange(
        mp_loc, dtype=torch.int32, device=block_table.device)[None, :]
    safe = torch.clamp(cols, max=mp - 1)
    gbt = torch.gather(block_table, 1, safe.long())               # (b, mp_loc)
    resident = (cols < mp) & (gbt // pps == shard)
    lbt = torch.where(resident, gbt % pps, torch.full_like(gbt, pps))
    page_pos = torch.where(resident, cols * page_size,
                           torch.full_like(cols, POS_PAD))
    return lbt.to(torch.int32), page_pos.to(torch.int32)


@dataclass
class ShardTables:
    """One step's GLOBAL block table cut for each bank, on the bank's
    device: the write tables (`localize_block_table`) and the compacted
    walks with their page positions (`_shard_local_walk`).  A hook
    builds it once per call (`shard_tables`) and hands it to every
    layer's write and walk."""
    writes: list
    walks: list
    positions: list


def shard_tables(cfg: ModelConfig, block_table, banks):
    """`ShardTables` of `block_table` for `banks` (one page leaf's
    per-bank tensors, any leading layer axis: (..., pps + 1, page, hkv,
    d)); None when `cfg.mem_axis` is unset.  The global table is handed
    to each bank's device once."""
    if cfg.mem_axis is None:
        return None
    n = len(banks)
    slots, page = banks[0].shape[-4], banks[0].shape[-3]
    pps = slots - 1
    out = ShardTables([], [], [])
    for s, bank in enumerate(banks):
        bt = C.hand(block_table, bank.device)
        out.writes.append(localize_block_table(cfg, bt, pps, s))
        lbt, pos = _shard_local_walk(n, s, bt, page, pps)
        out.walks.append(lbt)
        out.positions.append(pos)
    return out


def _sharded_attention(kernel, cfg: ModelConfig, q, k_pages, v_pages,
                       block_table, lengths, k_scale, v_scale, tables):
    """Every bank's partials-mode walk of its resident pages (the paged
    `kernel` on the bank's device, in its current stream, with that
    device's split scratch: `paged_attention/ops.py` keeps one per
    device), merged on q's device.  `lengths` are the kernel's per-row
    position arguments (decode: positions; prefill: start and
    chunk_len)."""
    tables = tables or shard_tables(cfg, block_table, k_pages)
    ms, ls, accs = [], [], []
    for s, (kb, vb) in enumerate(zip(k_pages, v_pages)):
        dev = kb.device
        kw = {}
        if k_scale is not None:
            kw = dict(k_scale=k_scale[s], v_scale=v_scale[s])
        m, l, acc = kernel(C.hand(q, dev), kb, vb, tables.walks[s],
                           *(C.hand(x, dev) for x in lengths),
                           page_positions=tables.positions[s],
                           partials=True, **kw)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return C.combine_shard_partials(ms, ls, accs, q.dtype, q.device)


def run_paged_decode_attention(cfg: ModelConfig, q, k_pages, v_pages,
                               block_table, positions,
                               k_scale=None, v_scale=None, tables=None):
    """Paged decode attention over ONE layer's arena: the CUDA kernel on
    the card, its plain version on the CPU.  q: (b, hq, d); returns
    (b, hq*d).

    With `cfg.mem_axis` set, the page leaves (scales included) are
    per-bank tuples and `block_table` holds GLOBAL ids: each bank walks
    its resident pages in partials mode (`tables`, or built here) and
    the (b, hq(, d)) summaries merge on q's device."""
    b, hq, d = q.shape
    if cfg.mem_axis is not None:
        o = _sharded_attention(paged_decode_attention, cfg, q, k_pages,
                               v_pages, block_table, (positions,),
                               k_scale, v_scale, tables)
    else:
        o = paged_decode_attention(q, k_pages, v_pages, block_table,
                                   positions, k_scale=k_scale,
                                   v_scale=v_scale)
    return o.reshape(b, hq * d)


def run_paged_prefill_attention(cfg: ModelConfig, q, k_pages, v_pages,
                                block_table, start, chunk_len,
                                k_scale=None, v_scale=None, tables=None):
    """Causal ragged chunk-prefill attention over ONE layer's arena (the
    chunk's own K/V already written).  q: (b, c, hq, d); returns
    (b, c, hq*d), rows past chunk_len zero.  With `cfg.mem_axis` set,
    each bank walks its resident pages and the (b, c, hq(, d)) chunk
    summaries merge, as in `run_paged_decode_attention`."""
    b, c, hq, d = q.shape
    if cfg.mem_axis is not None:
        o = _sharded_attention(paged_prefill_attention, cfg, q, k_pages,
                               v_pages, block_table, (start, chunk_len),
                               k_scale, v_scale, tables)
    else:
        o = paged_prefill_attention(q, k_pages, v_pages, block_table,
                                    start, chunk_len, k_scale=k_scale,
                                    v_scale=v_scale)
    return o.reshape(b, c, hq * d)


# --------------------------------------------------------------------- MLP

def mlp_init(gen, cfg: ModelConfig, device, d_ff: int | None = None):
    """The reference's leaves and standard deviations; `d_ff` overrides
    the hidden width (MoE shared experts: num_shared * moe_d_ff)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    pd = cfg.params_dtype
    p = {}
    if cfg.activation == "silu_glu":
        p["wg"] = _normal(gen, (d, f), std, pd, device)
    p["wi"] = _normal(gen, (d, f), std, pd, device)
    p["wo"] = _normal(gen, (f, d), out_std, pd, device)
    return p


def mlp_axes(cfg: ModelConfig):
    ax = {"wo": ("mlp", "embed")}
    if cfg.activation == "silu_glu":
        ax["wg"] = ("embed", "mlp")
    ax["wi"] = ("embed", "mlp")
    return ax


def silu(x):
    """The reference's `jax.nn.silu`: in bf16 its logistic and product
    as XLA computes them, each of neg, exp, add, reciprocal and mul
    rounded to bf16 (bit-exact with the reference on the CPU, where
    `F.silu`, rounding once, differs in about a third of bf16 values; a
    divide in place of the reciprocal is bit-exact too).  Other dtypes
    take `F.silu`."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1)


def gelu(x):
    """The reference's `jax.nn.gelu` (its default tanh approximation): in
    bf16 op by op as XLA computes it, x * x * x, then c (x + a cube),
    then x (0.5 (1 + tanh(.))), each rounded to bf16 with c, a, 0.5 and
    1 bf16 tensors (bit-exact with the reference on the CPU, where
    `F.gelu`, rounding once, differs in about a third of bf16 values).
    Other dtypes take `F.gelu`."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")

    def const(v):
        return torch.tensor(v, dtype=torch.bfloat16, device=x.device)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def mlp_apply(p, cfg: ModelConfig, x):
    """The MLP; tensor-parallel (wg/wi by column, wo by row, one
    all-reduce) when wi is this rank's slice."""
    g = C.tp_group(p["wi"])
    if g is not None:
        return C.reduce_from_tp(_mlp(p, cfg, C.copy_to_tp(x, g)), g)
    return _mlp(p, cfg, x)


def _mlp(p, cfg: ModelConfig, x):
    if cfg.activation == "silu_glu":
        h = silu(matmul(x, p["wg"])) * matmul(x, p["wi"])
    elif cfg.activation == "relu2":
        h = torch.relu(matmul(x, p["wi"])).square()
    elif cfg.activation == "gelu":
        h = gelu(matmul(x, p["wi"]))
    else:
        raise ValueError(cfg.activation)
    return matmul(h, p["wo"])


# -------------------------------------------------------------- embeddings

def embedding_init(gen, cfg: ModelConfig, device):
    return _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                   cfg.params_dtype, device)


def embedding_axes():
    # Vocab-parallel table; the d dim stays replicated: activations are
    # batch-sharded, so a data-sharded table d-dim would force an
    # all-to-all of the table (the reference's note).
    return ("vocab", None)


def _model_group(cfg: ModelConfig, n: int):
    """The bound mesh's model-axis group when it has more than one rank
    and `n` divides over it (the reference's condition), else None."""
    mesh = current_mesh()
    if (mesh is None or not getattr(mesh, "bound", False)
            or "model" not in mesh.axis_names or mesh.shape["model"] < 2
            or n % mesh.shape["model"]):
        return None
    return mesh.group("model")


def _vocab_parallel_lookup(emb, cfg: ModelConfig, tokens, g):
    """Megatron-style vocab-parallel embedding: `emb` is this rank's
    (vocab / m, d) rows; ids outside its range give zeros (a masked
    local gather), then one activation-sized all-reduce combines.  The
    backward is a LOCAL scatter-add: the table's gradient never crosses
    ranks."""
    v_loc = emb.shape[0]
    rel = tokens - g.index * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    x = emb.index_select(0, torch.clamp(rel, 0, v_loc - 1).reshape(-1))
    x = x.reshape(*tokens.shape, emb.shape[1]).to(cfg.compute_dtype)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return C.reduce_from_tp(x, g)


def embed_tokens(emb, cfg: ModelConfig, tokens):
    """tokens (...) int -> (..., d) in the compute dtype.  Vocab-parallel
    when `emb` is this rank's slice of the table, or when a bound mesh
    has a model axis over which the vocab divides (then this rank's rows
    of the full table are looked up)."""
    g = C.tp_group(emb)
    if g is None and emb.shape[0] == cfg.vocab_size:
        g = _model_group(cfg, cfg.vocab_size)
        if g is not None:
            v_loc = cfg.vocab_size // g.size
            emb = emb[g.index * v_loc:(g.index + 1) * v_loc]
    if g is not None:
        return _vocab_parallel_lookup(emb, cfg, tokens, g)
    x = emb.index_select(0, tokens.reshape(-1))
    return x.reshape(*tokens.shape, emb.shape[1]).to(cfg.compute_dtype)


def logits_from_hidden(emb_or_head, cfg: ModelConfig, x):
    """x: (b, s, d) @ head (d, vocab), or the tied embedding (vocab, d):
    tied is detected by `w.shape[0] == vocab_size`, as in the reference."""
    w = emb_or_head
    if w.shape[0] == cfg.vocab_size:          # tied: (vocab, d)
        return matmul(x, w.to(x.dtype).t())
    return matmul(x, w.to(x.dtype))


def _local_logits(w, cfg: ModelConfig, x):
    """x @ this rank's vocab slice of the head: (d, v_loc), or (v_loc, d)
    for a tied embedding."""
    w = w.to(x.dtype)
    return matmul(x, w.t() if cfg.tie_embeddings else w)


# ---------------------------------------------------------------- training

def attention_apply(p, cfg: ModelConfig, x, positions):
    """Full self-attention over x: (b, s, d) (the training forward);
    tensor-parallel when wq is this rank's slice of the heads."""
    g = C.tp_group(p["wq"])
    if g is not None:
        return _attention_tp(p, cfg, x, positions, g)
    b, s, _ = x.shape
    q, k, v = attention_qkv(p, cfg, x, positions)
    o = run_attention(cfg, q, k, v).reshape(b, s, cfg.q_dim)
    return matmul(o, p["wo"])


def _attention_tp(p, cfg: ModelConfig, x, positions, g):
    """Attention over this rank's query heads (wq's columns, wo's rows),
    then one all-reduce of the (b, s, d) output over the model axis.  The
    kv heads are this rank's slice when wk is tagged too; otherwise (fewer
    kv heads than ranks: the rule's fallback replicates them) every rank
    projects them all and keeps the ones its query heads read."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq = p["wq"].shape[1] // hd
    group = cfg.num_heads // cfg.num_kv_heads
    xt = C.copy_to_tp(x, g)
    q = matmul(xt, p["wq"]).reshape(b, s, hq, hd)
    if C.tp_group(p["wk"]) is not None:
        k = matmul(xt, p["wk"]).reshape(b, s, -1, hd)
        v = matmul(xt, p["wv"]).reshape(b, s, -1, hd)
    else:
        first, n = (g.index * hq) // group, max(1, hq // group)
        kv = cfg.num_kv_heads
        k = C.copy_to_tp(matmul(x, p["wk"]), g).reshape(b, s, kv, hd)
        v = C.copy_to_tp(matmul(x, p["wv"]), g).reshape(b, s, kv, hd)
        k, v = k[:, :, first:first + n], v[:, :, first:first + n]
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = run_attention(cfg, q, k, v).reshape(b, s, hq * hd)
    return C.reduce_from_tp(matmul(o, p["wo"]), g)


def _ce_sum(logits, labels):
    """(summed CE, count) over positions with label >= 0, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def cross_entropy(logits, labels):
    """Mean CE over positions with label >= 0.  logits: (..., V)."""
    tot, n = _ce_sum(logits, labels)
    return tot / torch.clamp(n, min=1.0)


def _ce_chunk(head, cfg: ModelConfig, h, lab):
    """(summed CE, count) of one chunk of positions."""
    return _ce_sum(logits_from_hidden(head, cfg, h), lab)


def chunked_ce_loss(hidden, head, cfg: ModelConfig, labels, chunk: int):
    """Mean CE, computing the logits one chunk of `chunk` positions at a
    time.  Each chunk runs under `torch.utils.checkpoint`: its (b, chunk,
    vocab) f32 logits are freed once its loss is summed and recomputed in
    the backward, so one chunk's logits are alive at a time (the
    reference's scan over chunks keeps O(chunk * vocab) live memory the
    same way)."""
    from torch.utils.checkpoint import checkpoint
    b, s, d = hidden.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            t, n = checkpoint(_ce_chunk, head, cfg, h, lab,
                              use_reentrant=False)
        else:
            t, n = _ce_chunk(head, cfg, h, lab)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _vocab_parallel_ce_sum(head, cfg: ModelConfig, h, lab, g):
    """(summed CE, count) of positions with label >= 0 from this rank's
    vocab slice of the logits: the row max and the sum of exponentials
    are all-reduced over the model axis (the max without a gradient: it
    cancels), and so is the label's logit, which only the rank holding
    that id contributes.  The (b, s, vocab) logits never exist whole."""
    logits = _local_logits(head, cfg, C.copy_to_tp(h, g)).float()
    v_loc = logits.shape[-1]
    m = C.all_reduce(logits.detach().amax(dim=-1), g, op="max",
                     name="tp_logit_max")
    se = C.reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1), g)
    lse = m + torch.log(se)
    rel = lab.long() - g.index * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    ll = torch.gather(logits, -1, torch.clamp(rel, 0, v_loc - 1)[..., None])
    ll = C.reduce_from_tp(ll[..., 0] * ok, g)
    mask = (lab >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss(hidden, head, cfg: ModelConfig, labels):
    """Mean CE of the head's logits over positions with label >= 0;
    vocab-parallel when `head` is this rank's vocab slice."""
    g = C.tp_group(head)
    chunk = cfg.logits_chunk
    if not (chunk and hidden.shape[1] % chunk == 0):
        chunk = 0
    if g is None:
        if chunk:
            return chunked_ce_loss(hidden, head, cfg, labels, chunk)
        return cross_entropy(logits_from_hidden(head, cfg, hidden), labels)
    from torch.utils.checkpoint import checkpoint
    chunk = chunk or hidden.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        args = (head, cfg, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                g)
        if torch.is_grad_enabled() and chunk < hidden.shape[1]:
            t, n = checkpoint(_vocab_parallel_ce_sum, *args,
                              use_reentrant=False)
        else:
            t, n = _vocab_parallel_ce_sum(*args)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)

