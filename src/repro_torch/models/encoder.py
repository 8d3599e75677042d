"""Encoder-only audio transformer (hubert-xlarge family): the training
forward and loss.

Port of `repro.models.encoder`.  The modality frontend is a stub:
`batch["frames"]` carries precomputed frame embeddings (b, s,
frontend_dim), projected to the model width by `in_proj`.  Training is
HuBERT's masked prediction: frames at masked positions are replaced by
a learned mask embedding, and the model predicts codebook targets there
(`labels` (b, s) int32, -1 at unmasked positions).  Attention is
non-causal and has no rotary embedding (`rope_theta` 0): the flash
kernel's non-causal path on the card, forward and backward.

There is no autoregressive decode, so no serving hook: the engine
refuses the family.
"""
from __future__ import annotations

import torch

from repro_torch.distribution.sharding import \
    with_logical_constraint as constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init(seed: int, cfg: ModelConfig, device):
    """Seeded random parameters with the reference's names, shapes,
    layouts and standard deviations (drawn from a `torch.Generator` on
    `device`, not the reference's bits)."""
    device = torch.device(device)
    gen = L.generator(device)
    gen.manual_seed(seed)
    pd = cfg.params_dtype
    return {
        "in_proj": L._normal(gen, (cfg.frontend_dim, cfg.d_model), 0.02, pd,
                             device),
        "mask_emb": L._normal(gen, (cfg.d_model,), 0.02, pd, device),
        "layers": [T.layer_init(gen, cfg, device)
                   for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_init(cfg, device),
        "head": L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, pd,
                          device),
    }


def param_axes(cfg: ModelConfig):
    """The logical axes of `init`'s tree: a list of per-layer axes."""
    return {
        "in_proj": ("embed", "norm"),   # frontend_dim == d_model; replicate out
        "mask_emb": ("norm",),
        "layers": [T.layer_axes(cfg) for _ in range(cfg.num_layers)],
        "ln_f": L.rmsnorm_axes(),
        "head": ("embed", "vocab"),
    }


def _encode(params, cfg: ModelConfig, frames, mask=None):
    """frames (b, s, frontend_dim) -> final hidden states (b, s, d); the
    rows where `mask` (b, s) is true take the mask embedding."""
    x = L.matmul(frames.to(cfg.compute_dtype), params["in_proj"])
    if mask is not None:
        x = torch.where(mask[..., None], params["mask_emb"].to(x.dtype), x)
    x = constrain(x, "act_batch", "act_seq", "act_embed")
    return T.forward_hidden(params, cfg, x, L.positions_of(x.shape[1],
                                                           x.device))


def forward(params, cfg: ModelConfig, batch):
    """batch: {"frames", optional "mask"} -> logits (b, s, vocab)."""
    h = _encode(params, cfg, batch["frames"], batch.get("mask"))
    return L.logits_from_hidden(params["head"], cfg, h)


def loss_fn(params, cfg: ModelConfig, batch):
    """Masked-prediction CE at the labelled (masked) positions; the mask
    defaults to `labels >= 0`."""
    mask = batch.get("mask")
    if mask is None:
        mask = batch["labels"] >= 0
    h = _encode(params, cfg, batch["frames"], mask)
    return L.lm_loss(h, params["head"], cfg, batch["labels"])


# encoder-only: no cache, prefill or decode
init_cache = None
cache_axes = None
prefill = None
decode_step = None
