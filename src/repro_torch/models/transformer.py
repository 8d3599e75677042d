"""Decoder-only transformer LM (llama-style, GQA, silu-GLU or relu^2):
the training forward and loss, and the serving hooks of the dense family,
contiguous and paged.

Port of `repro.models.transformer`.  Parameters are a
plain dict with the reference's names and layouts, except that
`params["layers"]` is a LIST of per-layer dicts instead of one pytree
stacked over a leading layer axis (`models/convert.py` maps between the
two): the layer loop is a Python loop, where the reference scans.

The contiguous cache (`init_cache`) is {"k", "v": (L, b, max_seq, hkv,
hd), "pos": (b,) int32}; `prefill` fills a batch from position 0 and
`decode_step` writes every row's token at its own `pos` (clamped to
max_seq - 1, as the reference's `dynamic_update_slice` clamps) and
advances every row.

The paged arena is a dict of (L, slots, page, hkv, hd) tensors (plus
(L, slots, page, hkv) f32 scale leaves when `cfg.kv_dtype` is int8/fp8)
whose LAST slot is the null page.  In the sharded serving step
(`cfg.mem_axis`, `serve/sharded/`) each page leaf is a TUPLE of per-bank
tensors (L, pps + 1, page, ...), bank s on its mesh device with its own
null slot last, and the block tables hold GLOBAL pool ids: the paged
hooks cut them per bank once per call (`layers.shard_tables`), write
each token into the bank that owns its page only, and walk each bank's
resident pages (`layers.run_paged_*_attention`).

Both hooks update their cache IN PLACE and return it: that replaces the
reference's functional updates, which its serving steps donate so XLA
can reuse the buffer.  `paged_verify` (speculative decode) is the paged
prefill walk with logits at every chunk position.
"""
from __future__ import annotations

import torch

from repro_torch.core.unimem import PAGED_SCALE_KEYS, is_page_leaf, quantize_kv
from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import gather_layer_params
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L


# ------------------------------------------------------------------ model

def layer_init(gen, cfg: ModelConfig, device):
    return {
        "ln1": L.rmsnorm_init(cfg, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (not its random bits: the draws come
    from a `torch.Generator` on `device`)."""
    device = torch.device(device)
    gen = L.generator(device)
    gen.manual_seed(seed)
    return init_from(gen, cfg, device)


def init_from(gen, cfg: ModelConfig, device):
    """`init`'s tree drawn from the generator `gen` (the vlm family draws
    its projector from the same generator after it)."""
    params = {
        "embed": L.embedding_init(gen, cfg, device),
        "layers": [layer_init(gen, cfg, device)
                   for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                   cfg.params_dtype, device)
    return params


def head_weights(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def layer_axes(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_axes(),
        "attn": L.attention_axes(),
        "ln2": L.rmsnorm_axes(),
        "mlp": L.mlp_axes(cfg),
    }


def param_axes(cfg: ModelConfig):
    """The logical axes of `init`'s tree, in the port's layout: a list of
    per-layer axes (the reference's stacked leaves carry a leading
    "stage" entry the port's lists do not)."""
    axes = {
        "embed": L.embedding_axes(),
        "layers": [layer_axes(cfg) for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_axes(),
    }
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


# --------------------------------------------------------------- training

def layer_apply(p, cfg: ModelConfig, x, positions):
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_apply(p["attn"], cfg, h, positions)
    h = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], cfg, h)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of products without a batch
    dimension (the weight projections: `x @ w` of a (b, s, d) x becomes
    one `aten.mm`, with a bias `aten.addmm`) and recompute the rest.
    Batched products (`aten.bmm`: the CPU attention paths' score and PV
    einsums) are recomputed, as the reference's
    `dots_with_no_batch_dims_saveable` recomputes them."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """`cfg.remat` over one layer: "none" keeps every activation the
    backward needs, "full" keeps the layer's input only and recomputes the
    rest in the backward, "dots" keeps the projections' outputs as well
    (`_save_dots`).  It changes memory and time, never a value.

    In a sharded step the layer's parameter shards are gathered into the
    weights it computes with INSIDE the remat region
    (`distribution.sharding.gather_layer_params`), so the gathered
    weights are freed with the layer's other activations and gathered
    again in the backward."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(cfg.remat)
    body = fn

    def fn(*args):
        return body(*gather_layer_params(args))
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def forward_hidden(params, cfg: ModelConfig, x, positions):
    """x: (b, s, d) embedded input -> final hidden states (after the
    final norm)."""
    body = _maybe_remat(layer_apply, cfg)
    for p in params["layers"]:
        x = body(p, cfg, x, positions)
    return L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (b, s)} -> logits (b, s, vocab)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    h = forward_hidden(params, cfg, x, positions)
    return L.logits_from_hidden(head_weights(params, cfg), cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens", "labels": (b, s)} -> mean next-token CE (f32
    scalar; labels < 0 are ignored)."""
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    h = forward_hidden(params, cfg, x, positions)
    return L.lm_loss(h, head_weights(params, cfg), cfg, labels)


# ---------------------------------------------------------------- serving

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device):
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_axes():
    """The reference's logical axes of each cache leaf (the batch axis
    is "act_batch")."""
    kv = (None, "act_batch", "act_kv_seq", None, None)
    return {"k": kv, "v": kv, "pos": ("act_batch",)}


def paged_cache_axes(cfg: ModelConfig | None = None):
    """The reference's logical axes of the paged arena: one pooled arena
    whose kv heads may shard over "model", pages whole (a page is the
    unit of residency); scale leaves (quantized arenas) follow the same
    layout minus the lane axis."""
    kv = (None, None, None, "act_kv_heads", None)
    axes = {"k": kv, "v": kv}
    if cfg is not None and cfg.kv_quantized:
        for name in PAGED_SCALE_KEYS:
            axes[name] = kv[:-1]
    return axes


def _mlp_ffn(p, cfg: ModelConfig, hn, valid):
    """Default per-layer FFN of the serving bodies.  `valid`: (b, s) row
    mask or None — ignored by the dense MLP (row-local)."""
    del valid
    return L.mlp_apply(p["mlp"], cfg, hn)


def prefill(params, cfg: ModelConfig, batch, cache, ffn_fn=_mlp_ffn):
    """Run whole prompts of one length from position 0: fill the cache
    rows [0, s) and set pos = s, in place.  batch: {"tokens": (b, s)}.
    Returns (cache, logits at the last position (b, vocab))."""
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    return prefill_embeds(params, cfg, x, cache, ffn_fn)


def prefill_embeds(params, cfg: ModelConfig, x, cache, ffn_fn=_mlp_ffn):
    """`prefill` over already-embedded prompts x: (b, s, d)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    for layer, p in enumerate(params["layers"]):
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, positions)
        o = L.run_attention(cfg, q, k, v).reshape(b, s, cfg.q_dim)
        x = x + L.matmul(o, p["attn"]["wo"])
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, None)
        cache["k"][layer, :, :s].copy_(k)
        cache["v"][layer, :, :s].copy_(v)
    cache["pos"].fill_(s)
    h = L.rmsnorm_apply(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


def decode_step(params, cfg: ModelConfig, cache, tokens, ffn_fn=_mlp_ffn):
    """One decode step.  tokens: (b,) int32; cache["pos"]: (b,) per-row
    lengths.  Every row writes its token's K/V at its own pos and
    advances, idle rows included.  Returns (cache, logits (b, vocab))."""
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])   # (b, 1, d)
    for layer, p in enumerate(params["layers"]):
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, pos[:, None])
        k_l, v_l = cache["k"][layer], cache["v"][layer]
        _scatter_kv(k_l, k, pos)
        _scatter_kv(v_l, v, pos)
        o = L.run_decode_attention(cfg, q[:, 0], k_l, v_l, pos)
        x = x + L.matmul(o, p["attn"]["wo"])[:, None, :]
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, None)
    cache["pos"].add_(1)
    h = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


def _scatter_kv(cache_l, kv_new, pos):
    """cache_l: (b, S, hkv, d); kv_new: (b, 1, hkv, d); pos: (b,).  Write
    row i at pos[i] in place, clamped into [0, S-1] as the reference's
    `dynamic_update_slice` clamps its start (an idle row's pos passes S)."""
    b, S = cache_l.shape[:2]
    idx = torch.clamp(pos.long(), 0, S - 1)
    cache_l[torch.arange(b, device=cache_l.device), idx] = \
        kv_new[:, 0].to(cache_l.dtype)


# ------------------------------------------------- paged serving (UniMem)
#
# Prefill is BATCHED and RAGGED: one call advances every admitting
# sequence by up to `chunk_len[i]` tokens of a shared (b, c) chunk.  Rows
# whose chunk_len is 0 are inert: their writes go to the null page and
# their logits are garbage the engine ignores.

def init_paged_cache(cfg: ModelConfig, num_slots: int, page_size: int,
                     max_batch: int = 0, *, device):
    """Physical page arena: `num_slots` includes the null slot the
    caller reserves.  `max_batch` is unused: attention-only families
    carry no per-slot state (hybrid does).  Under a quantized
    `cfg.kv_dtype` the K/V banks store int8/fp8 and per-token-per-head
    f32 scale leaves ride beside them."""
    dtype = cfg.kv_store_dtype
    shape = (cfg.num_layers, num_slots, page_size,
             cfg.num_kv_heads, cfg.head_dim)
    arena = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.kv_quantized:
        for name in PAGED_SCALE_KEYS:
            arena[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return arena


def _paged_write(arena_l, kv, block_table, start, valid=None):
    """Scatter a chunk's K or V (or scales) into ONE layer's pages in
    place.  arena_l: (slots, page, ...); kv: (b, c, ...); start: (b,)
    first absolute position of the chunk; valid: optional (b, c) bool —
    invalid positions (ragged tails, inert rows) go to the null slot (the
    LAST physical slot).  Table columns past the end are clamped: only
    invalid positions reach them, and those are redirected anyway."""
    page = arena_l.shape[1]
    b, c = kv.shape[0], kv.shape[1]
    pos = start[:, None] + torch.arange(c, dtype=start.dtype,
                                        device=start.device)[None, :]
    col = torch.clamp(pos // page, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table, 1, col.long())
    if valid is not None:
        phys = torch.where(valid, phys, torch.full_like(phys,
                                                        arena_l.shape[0] - 1))
    off = pos % page
    arena_l.index_put_((phys.reshape(-1).long(), off.reshape(-1).long()),
                       kv.reshape(b * c, *kv.shape[2:]).to(arena_l.dtype))


def _paged_write_kv(cfg: ModelConfig, leaves, k, v, block_table, start,
                    valid=None, tables=None):
    """Write a chunk's K/V into one layer's page leaves (views of the
    arena), quantizing on write when the arena stores int8/fp8.  Under
    `cfg.mem_axis` the leaves are per-bank tuples: the chunk's K/V are
    handed to every bank and written through its localized table
    (`tables.writes`, built here if not given), where the tokens of
    other banks' pages fall into the bank's null sink."""
    new = {"k": k, "v": v}
    if cfg.kv_quantized:
        qk, sk = quantize_kv(k, cfg.kv_store_dtype)
        qv, sv = quantize_kv(v, cfg.kv_store_dtype)
        new = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    if cfg.mem_axis is None:
        for name, x in new.items():
            _paged_write(leaves[name], x, block_table, start, valid)
        return
    tables = tables or L.shard_tables(cfg, block_table, leaves["k"])
    for s, wbt in enumerate(tables.writes):
        dev = wbt.device
        st = C.hand(start, dev)
        va = None if valid is None else C.hand(valid, dev)
        for name, x in new.items():
            _paged_write(leaves[name][s], C.hand(x, dev), wbt, st, va)


def _last_valid(x, chunk_len):
    """x: (b, c, d) -> (b, 1, d) row at index chunk_len-1 (clamped)."""
    idx = torch.clamp(chunk_len.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]


def _layer_leaves(arena, layer: int):
    """One layer's page leaves: views of the arena (per-bank tuples of
    views in a sharded arena)."""
    return {n: (tuple(b[layer] for b in a) if isinstance(a, tuple)
                else a[layer])
            for n, a in arena.items() if is_page_leaf(n)}


def paged_prefill_embeds(params, cfg: ModelConfig, x, arena, block_table,
                         start, chunk_len, ffn_fn=_mlp_ffn,
                         all_logits=False):
    """Shared prefill body over already-embedded chunk inputs x: (b,c,d).
    See `paged_prefill` for the contract.  With `all_logits` the head
    runs over EVERY chunk position and (b, c, vocab) comes back: the
    speculative-verify mode, where each position's next-token
    distribution judges one draft token."""
    b, c, _ = x.shape
    rows = torch.arange(c, dtype=start.dtype, device=start.device)
    positions = start[:, None] + rows[None, :]
    valid = rows[None, :] < chunk_len[:, None]                  # (b, c)
    tables = L.shard_tables(cfg, block_table, arena["k"])   # sharded only
    for layer, p in enumerate(params["layers"]):
        pg = _layer_leaves(arena, layer)
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, positions)
        _paged_write_kv(cfg, pg, k, v, block_table, start, valid, tables)
        # chunk queries attend through the block table IN PLACE — no
        # contiguous (b, max_pages*page, hkv, hd) copy on the kernel path
        o = L.run_paged_prefill_attention(cfg, q, pg["k"], pg["v"],
                                          block_table, start, chunk_len,
                                          k_scale=pg.get("k_scale"),
                                          v_scale=pg.get("v_scale"),
                                          tables=tables)
        x = x + L.matmul(o, p["attn"]["wo"])
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, valid)
    if all_logits:
        h = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
        return arena, L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    h = L.rmsnorm_apply(params["ln_f"], _last_valid(x, chunk_len),
                        cfg.norm_eps)
    logits = L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]


def paged_prefill(params, cfg: ModelConfig, chunk, arena, block_table,
                  start, chunk_len):
    """Prefill one RAGGED chunk of every admitting sequence's prompt.

    chunk: {"tokens": (b, c)} — a shared bucketed width c; row i holds
    chunk_len[i] <= c valid tokens at absolute positions
    start[i]..start[i]+chunk_len[i]-1; block_table: (b, max_pages)
    int32.  Writes each row's valid K/V into its pages (invalid tails go
    to the null slot), attends causally against everything already in
    the pages (shared prefix included), and returns (arena, logits at
    each row's LAST VALID position (b, vocab))."""
    x = L.embed_tokens(params["embed"], cfg, chunk["tokens"])
    return paged_prefill_embeds(params, cfg, x, arena, block_table,
                                start, chunk_len)


def paged_verify(params, cfg: ModelConfig, chunk, arena, block_table,
                 start, chunk_len, ffn_fn=_mlp_ffn):
    """Speculative-verify step: ONE ragged paged-prefill walk over the
    k+1 candidates [last_emitted, draft_0..draft_{k-1}] of every
    speculating row, with logits at EVERY chunk position.

    chunk/arena/block_table/start/chunk_len as in `paged_prefill` (inert
    rows: chunk_len 0, null-page tables).  The candidates' K/V land in
    the row's pages at start..start+k, so an accepted prefix's entries
    are already in place and the engine truncates the page tail past the
    accept point.  Returns (arena, logits (b, c, vocab)): logits[:, j]
    judges draft j (and, at j == k, draws the bonus token)."""
    x = L.embed_tokens(params["embed"], cfg, chunk["tokens"])
    return paged_prefill_embeds(params, cfg, x, arena, block_table,
                                start, chunk_len, ffn_fn=ffn_fn,
                                all_logits=True)


def paged_decode_step(params, cfg: ModelConfig, arena, block_table,
                      positions, tokens, ffn_fn=_mlp_ffn):
    """One decode step over the arena.  tokens: (b,) int32; positions:
    (b,) index each new token is written at (== current length);
    block_table: (b, max_pages).  Inactive rows point at the null slot
    (position 0 marks a row inactive for `ffn_fn` masking).  Returns
    (arena, logits (b, vocab))."""
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])   # (b, 1, d)
    valid = (positions > 0)[:, None]                            # (b, 1)
    tables = L.shard_tables(cfg, block_table, arena["k"])   # sharded only
    for layer, p in enumerate(params["layers"]):
        pg = _layer_leaves(arena, layer)
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, positions[:, None])
        _paged_write_kv(cfg, pg, k, v, block_table, positions, None, tables)
        o = L.run_paged_decode_attention(cfg, q[:, 0], pg["k"], pg["v"],
                                         block_table, positions,
                                         k_scale=pg.get("k_scale"),
                                         v_scale=pg.get("v_scale"),
                                         tables=tables)
        x = x + L.matmul(o, p["attn"]["wo"])[:, None, :]
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, valid)
    h = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]
