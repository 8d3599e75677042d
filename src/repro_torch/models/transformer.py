"""Decoder-only transformer LM (llama-style, GQA, silu-GLU or relu^2):
the paged serving hooks of the dense family.

Port of the paged half of `repro.models.transformer`.  Parameters are a
plain dict with the reference's names and layouts, except that
`params["layers"]` is a LIST of per-layer dicts instead of one pytree
stacked over a leading layer axis (`models/convert.py` maps between the
two): the layer loop is a Python loop, where the reference scans.

The paged arena is a dict of (L, slots, page, hkv, hd) tensors (plus
(L, slots, page, hkv) f32 scale leaves when `cfg.kv_dtype` is int8/fp8)
whose LAST slot is the null page.  The hooks update it IN PLACE
(`index_put_`) and return it: that replaces the reference's functional
`.at[].set` update, which its serving step donates so XLA can reuse the
buffer.  The contiguous-cache paths and `paged_verify` (speculative
decode) wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.core.unimem import PAGED_SCALE_KEYS, is_page_leaf, quantize_kv
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
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
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
                    valid=None):
    """Write a chunk's K/V into one layer's page leaves (views of the
    arena), quantizing on write when the arena stores int8/fp8."""
    if cfg.kv_quantized:
        qk, sk = quantize_kv(k, cfg.kv_store_dtype)
        qv, sv = quantize_kv(v, cfg.kv_store_dtype)
        _paged_write(leaves["k_scale"], sk, block_table, start, valid)
        _paged_write(leaves["v_scale"], sv, block_table, start, valid)
        k, v = qk, qv
    _paged_write(leaves["k"], k, block_table, start, valid)
    _paged_write(leaves["v"], v, block_table, start, valid)


def _last_valid(x, chunk_len):
    """x: (b, c, d) -> (b, 1, d) row at index chunk_len-1 (clamped)."""
    idx = torch.clamp(chunk_len.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]


def _mlp_ffn(p, cfg: ModelConfig, hn, valid):
    """Default per-layer FFN for the paged bodies.  `valid`: (b, s) row
    mask — ignored by the dense MLP (row-local)."""
    del valid
    return L.mlp_apply(p["mlp"], cfg, hn)


def _layer_leaves(arena, layer: int):
    return {n: a[layer] for n, a in arena.items() if is_page_leaf(n)}


def paged_prefill_embeds(params, cfg: ModelConfig, x, arena, block_table,
                         start, chunk_len, ffn_fn=_mlp_ffn):
    """Shared prefill body over already-embedded chunk inputs x: (b,c,d).
    See `paged_prefill` for the contract."""
    b, c, _ = x.shape
    rows = torch.arange(c, dtype=start.dtype, device=start.device)
    positions = start[:, None] + rows[None, :]
    valid = rows[None, :] < chunk_len[:, None]                  # (b, c)
    for layer, p in enumerate(params["layers"]):
        pg = _layer_leaves(arena, layer)
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, positions)
        _paged_write_kv(cfg, pg, k, v, block_table, start, valid)
        # chunk queries attend through the block table IN PLACE — no
        # contiguous (b, max_pages*page, hkv, hd) copy on the kernel path
        o = L.run_paged_prefill_attention(cfg, q, pg["k"], pg["v"],
                                          block_table, start, chunk_len,
                                          k_scale=pg.get("k_scale"),
                                          v_scale=pg.get("v_scale"))
        x = x + o @ p["attn"]["wo"]
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, valid)
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


def paged_decode_step(params, cfg: ModelConfig, arena, block_table,
                      positions, tokens, ffn_fn=_mlp_ffn):
    """One decode step over the arena.  tokens: (b,) int32; positions:
    (b,) index each new token is written at (== current length);
    block_table: (b, max_pages).  Inactive rows point at the null slot
    (position 0 marks a row inactive for `ffn_fn` masking).  Returns
    (arena, logits (b, vocab))."""
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])   # (b, 1, d)
    valid = (positions > 0)[:, None]                            # (b, 1)
    for layer, p in enumerate(params["layers"]):
        pg = _layer_leaves(arena, layer)
        hn = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, hn, positions[:, None])
        _paged_write_kv(cfg, pg, k, v, block_table, positions)
        o = L.run_paged_decode_attention(cfg, q[:, 0], pg["k"], pg["v"],
                                         block_table, positions,
                                         k_scale=pg.get("k_scale"),
                                         v_scale=pg.get("v_scale"))
        x = x + (o @ p["attn"]["wo"])[:, None, :]
        hn = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        x = x + ffn_fn(p, cfg, hn, valid)
    h = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = L.logits_from_hidden(head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]
