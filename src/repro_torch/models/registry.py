"""Model family registry — one functional interface per family.

The port serves the dense, MoE, hybrid and ssm families.  A family
module exposes
    init(seed, cfg, device) -> params
    init_cache(cfg, batch, max_seq, *, device) -> contiguous cache
    prefill(params, cfg, batch, cache)
    decode_step(params, cfg, cache, tokens)
and, where it can serve from the UniMem arena (all but ssm),
    init_paged_cache(cfg, num_slots, page_size, max_batch, *, device)
        page leaves (+ hybrid's per-slot conv/SSM state leaves)
    paged_prefill(params, cfg, chunk, arena, block_table, start, chunk_len)
    paged_decode_step(params, cfg, arena, block_table, positions, tokens)
Every serving hook returns (cache or arena, logits (b, vocab)); sampling
belongs to the serving step (serve/serve_step.py).  The encoder and vlm
families are not ported yet (ROADMAP.md queue A item 10).
"""
from __future__ import annotations

from repro_torch.models import hybrid, mamba2, moe, transformer
from repro_torch.models.config import ModelConfig

FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
}

# families of the reference not ported yet (ROADMAP.md queue A item 10)
_LATER = ("encoder", "vlm")


def get_family(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md queue A "
            f"item 10 (the other families)")
    raise ValueError(f"unknown model family {cfg.family!r}")


def has_paged(cfg: ModelConfig) -> bool:
    """True when the family can serve from the UniMem paged arena."""
    fam = get_family(cfg)
    return (getattr(fam, "init_paged_cache", None) is not None
            and getattr(fam, "paged_decode_step", None) is not None)
