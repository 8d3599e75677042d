"""Hybrid SSM + shared-attention model (zamba2 family): the paged
serving hooks.

Port of the paged half of `repro.models.hybrid`.  A Mamba-2 backbone
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
so decode-active and empty rows keep theirs.
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


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.num_layers // cfg.shared_attn_period, cfg.shared_attn_period


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (drawn from a `torch.Generator` on
    `device`, not the reference's bits)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
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


def _select_shared(params, cfg: ModelConfig, g: int):
    """Shared block g % num_shared_blocks."""
    return params["shared"][g % cfg.num_shared_blocks]


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


def _shared_tail(sp, scfg, cat, o, proj_g, h):
    """Attention output -> MLP -> projection back onto the hidden state."""
    cat = cat + o @ sp["attn"]["wo"]
    h2 = L.rmsnorm_apply(sp["ln2"], cat, scfg.norm_eps)
    cat = cat + L.mlp_apply(sp["mlp"], scfg, h2)
    return h + cat @ proj_g


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
        T._paged_write_kv(scfg, pg, k, v, block_table, start, valid)
        o = L.run_paged_prefill_attention(scfg, q, pg["k"], pg["v"],
                                          block_table, start, chunk_len,
                                          k_scale=pg.get("k_scale"),
                                          v_scale=pg.get("v_scale"))
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
        T._paged_write_kv(scfg, pg, k, v, block_table, positions)
        o = L.run_paged_decode_attention(scfg, q[:, 0], pg["k"], pg["v"],
                                         block_table, positions,
                                         k_scale=pg.get("k_scale"),
                                         v_scale=pg.get("v_scale"))
        x = _shared_tail(sp, scfg, cat[:, 0], o, params["group_proj"][g], x)
    h = L.rmsnorm_apply(params["ln_f"], x[:, None], cfg.norm_eps)
    logits = L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)
    return arena, logits[:, 0]
