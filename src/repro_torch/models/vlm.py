"""VLM (phi-3-vision family): a phi3-mini text backbone and a CLIP patch
stub: the training forward and loss, and the serving hooks, contiguous
and paged.

Port of `repro.models.vlm`.  The vision frontend is a stub:
`batch["patch_embeds"]` carries precomputed patch embeddings (b,
num_patches, frontend_dim).  A 2-layer MLP projector (`img_proj`, w1
and w2 with a gelu between) maps them into the text embedding space,
and the image rows are prepended to the text (causal over the whole
sequence).  The loss counts text positions only.

The params tree is the dense transformer's plus `img_proj`, and after
prefill the cache holds no trace of the modality, so decode, the cache
and the arena are the transformer's own hooks.  A paged prefill chunk
is multimodal: each (b, c) chunk carries tokens AND a (b, c,
frontend_dim) patch plane; virtual positions below `num_patches` take
the projected patch row, the rest the token embedding, and the chunk
rides `transformer.paged_prefill_embeds` (the paged-prefill kernel on
the card).
"""
from __future__ import annotations

import torch

from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import seq_block, seq_shard
from repro_torch.distribution.sharding import \
    with_logical_constraint as constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations: the transformer's tree, then the
    projector's two matrices, all from one `torch.Generator` on
    `device`."""
    device = torch.device(device)
    gen = L.generator(device)
    gen.manual_seed(seed)
    params = T.init_from(gen, cfg, device)
    params["img_proj"] = {
        "w1": L._normal(gen, (cfg.frontend_dim, cfg.d_model), 0.02,
                        cfg.params_dtype, device),
        "w2": L._normal(gen, (cfg.d_model, cfg.d_model), 0.02,
                        cfg.params_dtype, device),
    }
    return params


def param_axes(cfg: ModelConfig):
    axes = T.param_axes(cfg)
    axes["img_proj"] = {"w1": ("norm", "embed"), "w2": ("embed", "norm")}
    return axes


def _project_patches(params, cfg: ModelConfig, patch_embeds):
    """(..., frontend_dim) patch rows -> (..., d) in the compute dtype:
    w1, gelu, w2, each as the reference rounds it (`layers.matmul`,
    `layers.gelu`)."""
    p = params["img_proj"]
    h = L.matmul(patch_embeds.to(cfg.compute_dtype), p["w1"])
    h = L.matmul(L.gelu(h), p["w2"])
    if h.dim() != 3:
        return h
    return constrain(h, "act_batch", "act_patch", "act_embed")


def _fused_input(params, cfg: ModelConfig, batch):
    """[projected patches | token embeddings]: (b, num_patches + s, d).
    In a sharded step that cuts the text over "model" each rank embeds
    its block of the tokens, and the blocks are all-gathered along the
    sequence; the patch rows are projected whole ("act_patch" is
    replicated).  Where the step cuts the trunk, each rank keeps its
    block of the fused rows."""
    img = _project_patches(params, cfg, batch["patch_embeds"])
    tokens = batch["tokens"]
    sg = seq_shard("seq")
    if sg is not None:
        tokens = seq_block(tokens, sg)
    txt = L.embed_tokens(params["embed"], cfg, tokens)
    if sg is not None:
        txt = C.all_gather_grad(txt, [(sg, 1)], names=(
            "seq_all_gather", "seq_reduce_scatter"))
    x = torch.cat([img, txt], dim=1)
    tg = seq_shard()
    if tg is not None:
        x = seq_block(x, tg)
    return constrain(x, "act_batch", "act_seq", "act_embed")


def _hidden(params, cfg: ModelConfig, batch):
    x = _fused_input(params, cfg, batch)
    return T.forward_hidden(params, cfg, x, L.positions_of(x.shape[1],
                                                           x.device))


def forward(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (b, s), "patch_embeds": (b, p, frontend_dim)}
    -> logits (b, p + s, vocab)."""
    h = _hidden(params, cfg, batch)
    return L.logits_from_hidden(T.head_weights(params, cfg), cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean CE on text positions; the image positions are labelled -1
    (ignored)."""
    h = _hidden(params, cfg, batch)
    labels = batch["labels"]
    p = batch["patch_embeds"].shape[1]
    img_ignore = torch.full((labels.shape[0], p), -1, dtype=labels.dtype,
                            device=labels.device)
    labels = torch.cat([img_ignore, labels], dim=1)
    tg = seq_shard()
    if tg is not None:
        labels = seq_block(labels, tg)
    return L.lm_loss(h, T.head_weights(params, cfg), cfg, labels)


# ---------------------------------------------------------------- serving

init_cache = T.init_cache
cache_axes = T.cache_axes
decode_step = T.decode_step          # the params tree is a superset
init_paged_cache = T.init_paged_cache
paged_cache_axes = T.paged_cache_axes
paged_decode_step = T.paged_decode_step


def paged_prefill(params, cfg: ModelConfig, chunk, arena, block_table,
                  start, chunk_len):
    """Ragged multimodal chunk prefill.  chunk: {"tokens": (b, c),
    "patches": (b, c, frontend_dim)}: row i's virtual prompt is
    [num_patches image rows | text tokens]; positions below
    `cfg.num_patches` read the projected patch plane, the rest the token
    embedding.  Otherwise `transformer.paged_prefill`'s contract."""
    tokens = chunk["tokens"]
    c = tokens.shape[1]
    positions = start[:, None] + torch.arange(c, dtype=start.dtype,
                                              device=start.device)[None, :]
    img = _project_patches(params, cfg, chunk["patches"])
    txt = L.embed_tokens(params["embed"], cfg, tokens)
    x = torch.where((positions < cfg.num_patches)[..., None], img, txt)
    return T.paged_prefill_embeds(params, cfg, x, arena, block_table,
                                  start, chunk_len)


def prefill(params, cfg: ModelConfig, batch, cache):
    """Multimodal contiguous prefill: the image rows and the prompt
    tokens fill the cache from position 0 (`transformer.prefill`'s
    contract over the fused input)."""
    return T.prefill_embeds(params, cfg, _fused_input(params, cfg, batch),
                            cache)
