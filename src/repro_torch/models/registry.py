"""Model family registry — one functional interface per family.

The port has all six families of the reference: dense, MoE, hybrid,
ssm and vlm serve; the encoder trains only.  A serving family module
exposes
    init(seed, cfg, device) -> params
    init_cache(cfg, batch, max_seq, *, device) -> contiguous cache
    prefill(params, cfg, batch, cache)
    decode_step(params, cfg, cache, tokens)
and, where it can serve from the UniMem arena (all but ssm),
    init_paged_cache(cfg, num_slots, page_size, max_batch, *, device)
        page leaves (+ hybrid's per-slot conv/SSM state leaves)
    paged_prefill(params, cfg, chunk, arena, block_table, start, chunk_len)
    paged_decode_step(params, cfg, arena, block_table, positions, tokens)
and, where it can be a speculative-decode target (dense, moe),
    paged_verify(params, cfg, chunk, arena, block_table, start, chunk_len)
        the prefill walk with logits at every chunk position.
Every serving hook returns (cache or arena, logits); sampling belongs to
the serving step (serve/serve_step.py).  Training: every family exposes
    loss_fn(params, cfg, batch) -> mean CE (f32 scalar; MoE adds its
        router losses)
and `forward(params, cfg, batch)` -> logits.  The draft pairing of
speculative decode (`DRAFT_PAIRS`, `draft_config`, `self_draft_params`)
lives here too.  The encoder family's serving hooks are None (no
decode), and the vlm's prompts carry patch rows (`Request.patch_embeds`),
so it cannot be a speculative-decode target.
"""
from __future__ import annotations

from repro_torch.models import (encoder, hybrid, mamba2, moe,
                                transformer, vlm)
from repro_torch.models.config import ModelConfig

FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
    "encoder": encoder,
    "vlm": vlm,
}


def get_family(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}")


def has_paged(cfg: ModelConfig) -> bool:
    """True when the family can serve from the UniMem paged arena."""
    fam = get_family(cfg)
    return (getattr(fam, "init_paged_cache", None) is not None
            and getattr(fam, "paged_decode_step", None) is not None)


def has_decode(cfg: ModelConfig) -> bool:
    return getattr(get_family(cfg), "decode_step", None) is not None


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic families run long_500k; pure full-attention skip it."""
    return cfg.family in ("ssm", "hybrid")


# --------------------------------------------- speculative decode drafts
#
# A draft proposes k tokens from its own contiguous cache and the target
# judges them in ONE ragged paged-prefill walk (`paged_verify`).  Only
# families whose paged path gives all-position logits and whose prompts
# are plain token streams can be targets: hybrid's per-slot conv/SSM
# state cannot roll back a rejected tail, and ssm has no paged path.

# target arch -> default draft arch; any other target falls back to the
# truncated self-draft "self:1" (its first layer with the shared embed,
# final norm and head: no extra weights)
DRAFT_PAIRS = {
    "internlm2-1.8b": "mamba2-130m",
    "deepseek-67b": "mamba2-130m",
    "yi-9b": "mamba2-130m",
}

SELF_DRAFT_PREFIX = "self:"


def has_verify(cfg: ModelConfig) -> bool:
    """True when `cfg` can be a speculative-decode TARGET: the family
    has a paged verify hook and the prompts are plain token streams."""
    fam = get_family(cfg)
    return (getattr(fam, "paged_verify", None) is not None
            and cfg.frontend == "none")


def default_draft(cfg: ModelConfig) -> str:
    """The registry's draft pairing for a target config."""
    return DRAFT_PAIRS.get(cfg.name, SELF_DRAFT_PREFIX + "1")


def draft_config(cfg: ModelConfig, spec: str) -> ModelConfig:
    """Resolve a draft spec against a target config.

    "self:N"          -> the target truncated to its first N layers
                         (params sliced by `self_draft_params`).
    "<arch>"          -> that registered config, vocab coerced to the
                         target's (the draft's samples index the
                         target's vocab).
    "<arch>@reduced"  -> the same, shrunk by `reduced_for_smoke`.
    """
    if spec.startswith(SELF_DRAFT_PREFIX):
        n = int(spec[len(SELF_DRAFT_PREFIX):])
        if not 1 <= n < cfg.num_layers:
            raise ValueError(
                f"self-draft depth {n} must be in [1, {cfg.num_layers - 1}] "
                f"for a {cfg.num_layers}-layer target")
        return cfg.replace(name=f"{cfg.name}-self{n}", num_layers=n)
    from repro_torch.configs import get_arch
    from repro_torch.models.config import reduced_for_smoke
    arch, _, flag = spec.partition("@")
    d = get_arch(arch).model
    if flag == "reduced":
        d = reduced_for_smoke(d, max_seq=cfg.max_seq)
    elif flag:
        raise ValueError(f"unknown draft flag {flag!r} in {spec!r}")
    if not has_decode(d):
        raise ValueError(f"draft arch {arch!r} has no decode path")
    return d.replace(vocab_size=cfg.vocab_size,
                     max_seq=max(d.max_seq, cfg.max_seq))


def is_self_draft(cfg: ModelConfig, dcfg: ModelConfig) -> bool:
    return (dcfg.family == cfg.family
            and dcfg.name == f"{cfg.name}-self{dcfg.num_layers}")


def self_draft_params(params, dcfg: ModelConfig):
    """Truncated self-draft weights: the target's first
    `dcfg.num_layers` layer dicts; embed, final norm and head are the
    target's own tensors (the same storage, no copy)."""
    out = dict(params)
    out["layers"] = params["layers"][:dcfg.num_layers]
    return out
