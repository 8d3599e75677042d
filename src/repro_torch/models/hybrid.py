"""Hybrid SSM + shared-attention model (zamba2 family): the serving
hooks, contiguous and paged, and training (`forward`, `loss_fn`).

Port of `repro.models.hybrid`.  A Mamba-2 backbone
with a SHARED transformer block applied every `shared_attn_period`
layers (zamba2-2.7b: every 6 of 54, 9 applications alternating between
`num_shared_blocks` = 2 blocks).  The shared block runs on
concat([hidden, initial embedding]) at width 2 * d_model and a
per-application linear projects it back to d_model.

Parameters keep the reference's names and layouts, with its stacked
leaves split into lists: `params["mamba"]` is a G x P nested list of
layer dicts (G = num_layers // shared_attn_period groups of P =
shared_attn_period layers), `params["shared"]` a list of
`num_shared_blocks` block dicts and `params["group_proj"]` a list of G
(2d, d) matrices.

The paged arena holds the shared attention's K/V pages, one write site
per GROUP ((G, slots, page, hkv, hd)), and beside them the Mamba conv
and SSM state, contiguous per engine slot ("conv" (G, P, max_batch,
width-1, channels), "ssm" (G, P, max_batch, h, p, n); batch row i ==
engine slot i, slot axis `kv_cache.STATE_SLOT_AXIS`).  The hooks update
pages AND state IN PLACE and return the arena: a row's state starts
from zero when its chunk starts at position 0, and is written back only
where the row advanced (prefill: chunk_len > 0; decode: position > 0),
so decode-active and empty rows keep theirs.  In a sharded arena
(`cfg.mem_axis`) the pages are per-bank tuples and the state leaves live
once, on the lead device (the reference replicates them on every bank,
which gives the same values).

The contiguous cache (`init_cache`) holds the same conv/SSM rows with
the batch on axis 2 beside (G, b, max_seq, hkv, hd) K/V and a (b,) pos;
its hooks update it in place too, and decode advances every row's
state, idle rows included, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core.unimem import PAGED_SCALE_KEYS
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block runs at width 2 * d_model."""
    return cfg.replace(d_model=2 * cfg.d_model, family="dense")


def shared_block_init(gen, cfg: ModelConfig, device):
    scfg = _shared_cfg(cfg)
    return {
        "ln1": L.rmsnorm_init(scfg, device),
        "attn": L.attention_init(gen, scfg, device),
        "ln2": L.rmsnorm_init(scfg, device),
        "mlp": L.mlp_init(gen, scfg, device),
    }


def shared_block_axes(cfg: ModelConfig):
    scfg = _shared_cfg(cfg)
    return {
        "ln1": L.rmsnorm_axes(),
        "attn": L.attention_axes(),
        "ln2": L.rmsnorm_axes(),
        "mlp": L.mlp_axes(scfg),
    }


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.num_layers // cfg.shared_attn_period, cfg.shared_attn_period


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (drawn from a `torch.Generator` on
    `device`, not the reference's bits)."""
    device = torch.device(device)
    gen = L.generator(device)
    gen.manual_seed(seed)
    G, P = _groups(cfg)
    params = {
        "embed": L.embedding_init(gen, cfg, device),
        "mamba": [[M.layer_init(gen, cfg, device) for _ in range(P)]
                  for _ in range(G)],
        "shared": [shared_block_init(gen, cfg, device)
                   for _ in range(cfg.num_shared_blocks)],
        "group_proj": [L._normal(gen, (2 * cfg.d_model, cfg.d_model), 0.02,
                                 cfg.params_dtype, device)
                       for _ in range(G)],
        "ln_f": L.rmsnorm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                   cfg.params_dtype, device)
    return params


def param_axes(cfg: ModelConfig):
    """The logical axes of `init`'s tree in the port's layout: `mamba` a
    G x P nested list of layer axes, `shared` and `group_proj` lists (the
    reference's stacked leaves carry leading "stage" entries instead)."""
    G, P = _groups(cfg)
    axes = {
        "embed": L.embedding_axes(),
        "mamba": [[M.layer_axes(cfg) for _ in range(P)] for _ in range(G)],
        "shared": [shared_block_axes(cfg)
                   for _ in range(cfg.num_shared_blocks)],
        "group_proj": [("heads", "embed") for _ in range(G)],
        "ln_f": L.rmsnorm_axes(),
    }
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


def _select_shared(params, cfg: ModelConfig, g: int):
    """Shared block g % num_shared_blocks."""
    return params["shared"][g % cfg.num_shared_blocks]


def _shared_tail(sp, scfg, cat, o, proj_g, h):
    """Attention output -> MLP -> projection back onto the hidden state."""
    cat = cat + L.matmul(o, sp["attn"]["wo"])
    h2 = L.rmsnorm_apply(sp["ln2"], cat, scfg.norm_eps)
    cat = cat + L.mlp_apply(sp["mlp"], scfg, h2)
    return h + L.matmul(cat, proj_g)


# ---------------------------------------------------------------- serving

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device):
    dtype = dtype or cfg.compute_dtype
    G, P = _groups(cfg)
    kv_shape = (G, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv": zeros((G, P, batch, cfg.conv_width - 1, cfg.conv_channels)),
        "ssm": zeros((G, P, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)),
        "k": zeros(kv_shape),
        "v": zeros(kv_shape),
        "pos": zeros((batch,), torch.int32),
    }


def cache_axes():
    """The reference's logical axes; the conv/SSM batch axis is 2."""
    kv = (None, "act_batch", "act_kv_seq", None, None)
    return {
        "conv": (None, None, "act_batch", None, "ssm_inner"),
        "ssm": (None, None, "act_batch", "act_ssm_heads", None, None),
        "k": kv,
        "v": kv,
        "pos": ("act_batch",),
    }


def paged_cache_axes(cfg: ModelConfig | None = None):
    """The reference's logical axes of the paged arena (K/V pages with
    kv heads on "model", the contiguous conv/SSM state rows)."""
    kv = (None, None, None, "act_kv_heads", None)
    axes = {
        "k": kv, "v": kv,
        "conv": (None, None, "act_batch", None, "ssm_inner"),
        "ssm": (None, None, "act_batch", "act_ssm_heads", None, None),
    }
    if cfg is not None and cfg.kv_quantized:
        for name in PAGED_SCALE_KEYS:
            axes[name] = kv[:-1]
    return axes


def prefill(params, cfg: ModelConfig, batch, cache):
    """Whole prompts from position 0: the Mamba blocks' final conv tails
    and SSM states and the shared attention's K/V land in the cache, in
    place.  Returns (cache, logits at the last position (b, vocab))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    scfg = _shared_cfg(cfg)
    G, P = _groups(cfg)
    x = L.embed_tokens(params["embed"], cfg, tokens)
    x0 = x
    positions = torch.arange(s, device=tokens.device)[None, :]
    for g in range(G):
        for i in range(P):
            p = params["mamba"][g][i]
            hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
            out, (S, tail) = M.block_apply(p["mixer"], cfg, hn,
                                           return_state=True)
            x = x + out
            cache["conv"][g, i].copy_(tail)
            cache["ssm"][g, i].copy_(S)
        sp = _select_shared(params, cfg, g)
        cat = torch.cat([x, x0], dim=-1)
        hn = L.rmsnorm_apply(sp["ln1"], cat, cfg.norm_eps)
        q, k, v = L.attention_qkv(sp["attn"], scfg, hn, positions)
        o = L.run_attention(scfg, q, k, v).reshape(b, s, scfg.q_dim)
        x = _shared_tail(sp, scfg, cat, o, params["group_proj"][g], x)
        cache["k"][g, :, :s].copy_(k)
        cache["v"][g, :, :s].copy_(v)
    cache["pos"].fill_(s)
    h = L.rmsnorm_apply(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step for every row: the SSM recurrence on each row's
    state and split-KV attention over the shared blocks' contiguous K/V.
    Returns (cache, logits (b, vocab))."""
    scfg = _shared_cfg(cfg)
    G, P = _groups(cfg)
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])[:, 0]   # (b, d)
    x0 = x
    for g in range(G):
        for i in range(P):
            p = params["mamba"][g][i]
            conv, ssm = cache["conv"][g, i], cache["ssm"][g, i]
            hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
            y, conv_c, ssm_c = M.block_step(p["mixer"], cfg, hn, conv, ssm)
            x = x + y
            conv.copy_(conv_c)
            ssm.copy_(ssm_c)
        sp = _select_shared(params, cfg, g)
        cat = torch.cat([x, x0], dim=-1)[:, None, :]                   # (b,1,2d)
        hn = L.rmsnorm_apply(sp["ln1"], cat, cfg.norm_eps)
        q, k, v = L.attention_qkv(sp["attn"], scfg, hn, pos[:, None])
        k_g, v_g = cache["k"][g], cache["v"][g]
        T._scatter_kv(k_g, k, pos)
        T._scatter_kv(v_g, v, pos)
        o = L.run_decode_attention(scfg, q[:, 0], k_g, v_g, pos)
        x = _shared_tail(sp, scfg, cat[:, 0], o, params["group_proj"][g], x)
    cache["pos"].add_(1)
    h = L.rmsnorm_apply(params["ln_f"], x[:, None], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return cache, logits[:, 0]


# ------------------------------------------------- paged serving (UniMem)

def init_paged_cache(cfg: ModelConfig, num_slots: int, page_size: int,
                     max_batch: int = 1, *, device):
    """K/V pages per group (+ scale leaves when quantized) and the
    per-slot conv/SSM state rows, in the compute dtype."""
    G, P = _groups(cfg)
    kv_shape = (G, num_slots, page_size, cfg.num_kv_heads, cfg.head_dim)
    state = cfg.compute_dtype
    arena = {
        "k": torch.zeros(kv_shape, dtype=cfg.kv_store_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.kv_store_dtype, device=device),
        "conv": torch.zeros((G, P, max_batch, cfg.conv_width - 1,
                             cfg.conv_channels), dtype=state, device=device),
        "ssm": torch.zeros((G, P, max_batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=state, device=device),
    }
    if cfg.kv_quantized:
        for name in PAGED_SCALE_KEYS:
            arena[name] = torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                      device=device)
    return arena


def paged_prefill(params, cfg: ModelConfig, chunk, arena, block_table,
                  start, chunk_len):
    """Ragged-chunk prefill: attention K/V through the block tables,
    conv/SSM state threaded through the arena's per-slot rows.  Same
    contract as `transformer.paged_prefill`; b must equal the arena's
    max_batch (batch row i == engine slot i)."""
    tokens = chunk["tokens"]
    b, c = tokens.shape
    scfg = _shared_cfg(cfg)
    G, P = _groups(cfg)
    x = L.embed_tokens(params["embed"], cfg, tokens)
    x0 = x
    rows = torch.arange(c, dtype=start.dtype, device=start.device)
    positions = start[:, None] + rows[None, :]
    valid = rows[None, :] < chunk_len[:, None]
    # rows whose chunk starts the prompt run from zero state; continuing
    # rows pick up the state their previous chunk wrote back
    live = (start > 0).to(arena["conv"].dtype)
    adv = chunk_len > 0                  # state writeback only where advanced
    tables = L.shard_tables(scfg, block_table, arena["k"])  # sharded only
    for g in range(G):
        for i in range(P):
            p = params["mamba"][g][i]
            conv, ssm = arena["conv"][g, i], arena["ssm"][g, i]
            hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
            y, conv_c, ssm_c = M.block_prefill_chunk(
                p["mixer"], cfg, hn, conv * live[:, None, None],
                ssm * live[:, None, None, None], valid)
            x = x + y
            conv.copy_(torch.where(adv[:, None, None], conv_c.to(conv.dtype),
                                   conv))
            ssm.copy_(torch.where(adv[:, None, None, None],
                                  ssm_c.to(ssm.dtype), ssm))
        sp = _select_shared(params, cfg, g)
        pg = T._layer_leaves(arena, g)
        cat = torch.cat([x, x0], dim=-1)
        hn = L.rmsnorm_apply(sp["ln1"], cat, cfg.norm_eps)
        q, k, v = L.attention_qkv(sp["attn"], scfg, hn, positions)
        T._paged_write_kv(scfg, pg, k, v, block_table, start, valid, tables)
        o = L.run_paged_prefill_attention(scfg, q, pg["k"], pg["v"],
                                          block_table, start, chunk_len,
                                          k_scale=pg.get("k_scale"),
                                          v_scale=pg.get("v_scale"),
                                          tables=tables)
        x = _shared_tail(sp, scfg, cat, o, params["group_proj"][g], x)
    h = L.rmsnorm_apply(params["ln_f"], T._last_valid(x, chunk_len),
                        cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]


def paged_decode_step(params, cfg: ModelConfig, arena, block_table,
                      positions, tokens):
    """One decode step: paged attention over the arena per group, the
    single-token SSM recurrence on the per-slot state rows.  Inactive
    rows (position 0, null block tables) neither advance their state nor
    write real pages."""
    scfg = _shared_cfg(cfg)
    G, P = _groups(cfg)
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])[:, 0]   # (b, d)
    x0 = x
    act = positions > 0              # inactive rows keep their stored state
    tables = L.shard_tables(scfg, block_table, arena["k"])  # sharded only
    for g in range(G):
        for i in range(P):
            p = params["mamba"][g][i]
            conv, ssm = arena["conv"][g, i], arena["ssm"][g, i]
            hn = L.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
            y, conv_c, ssm_c = M.block_step(p["mixer"], cfg, hn, conv, ssm)
            x = x + y
            conv.copy_(torch.where(act[:, None, None], conv_c.to(conv.dtype),
                                   conv))
            ssm.copy_(torch.where(act[:, None, None, None],
                                  ssm_c.to(ssm.dtype), ssm))
        sp = _select_shared(params, cfg, g)
        pg = T._layer_leaves(arena, g)
        cat = torch.cat([x, x0], dim=-1)[:, None, :]                   # (b,1,2d)
        hn = L.rmsnorm_apply(sp["ln1"], cat, cfg.norm_eps)
        q, k, v = L.attention_qkv(sp["attn"], scfg, hn, positions[:, None])
        T._paged_write_kv(scfg, pg, k, v, block_table, positions, None,
                          tables)
        o = L.run_paged_decode_attention(scfg, q[:, 0], pg["k"], pg["v"],
                                         block_table, positions,
                                         k_scale=pg.get("k_scale"),
                                         v_scale=pg.get("v_scale"),
                                         tables=tables)
        x = _shared_tail(sp, scfg, cat[:, 0], o, params["group_proj"][g], x)
    h = L.rmsnorm_apply(params["ln_f"], x[:, None], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]


# ---------------------------------------------------------------- training

def _shared_apply(sp, cfg: ModelConfig, h, x0, proj_g, positions):
    """The shared block on concat([h, x0]) at width 2d, projected back
    onto h (the reference's `_shared_apply`, in its op order)."""
    scfg = _shared_cfg(cfg)
    b, s, _ = h.shape
    cat = torch.cat([h, x0], dim=-1)
    hn = L.rmsnorm_apply(sp["ln1"], cat, cfg.norm_eps)
    q, k, v = L.attention_qkv(sp["attn"], scfg, hn, positions)
    o = L.run_attention(scfg, q, k, v).reshape(b, s, scfg.q_dim)
    return _shared_tail(sp, scfg, cat, o, proj_g, h)


def forward_hidden(params, cfg: ModelConfig, x):
    """x: (b, s, d) embedded input -> final hidden states (after the final
    norm).  Each group (its P Mamba layers, then shared block g %
    num_shared_blocks and its projection) runs under `cfg.remat`
    (`transformer._maybe_remat`), as the reference remats its group
    scan's body; the shared blocks' gradients sum over their
    applications."""
    G, _ = _groups(cfg)
    x0 = x
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def group(h, mamba, shared, proj):
        for p in mamba:
            h = M._layer_apply(p, cfg, h)
        return _shared_apply(shared, cfg, h, x0, proj, positions)

    body = T._maybe_remat(group, cfg)
    for g in range(G):
        x = body(x, params["mamba"][g], _select_shared(params, cfg, g),
                 params["group_proj"][g])
    return L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (b, s)} -> logits (b, s, vocab)."""
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    h = forward_hidden(params, cfg, x)
    return L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens", "labels": (b, s)} -> mean next-token CE (f32
    scalar; labels < 0 are ignored)."""
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    h = forward_hidden(params, cfg, x)
    return L.lm_loss(h, T.head_weights(params, cfg), cfg, batch["labels"])
