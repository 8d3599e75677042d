"""Model family registry — one functional interface per family.

The port serves the dense, MoE and hybrid families from the paged
arena.  A family module exposes
    init(seed, cfg, device) -> params
    init_paged_cache(cfg, num_slots, page_size, max_batch, *, device)
        page leaves (+ hybrid's per-slot conv/SSM state leaves)
    paged_prefill(params, cfg, chunk, arena, block_table, start, chunk_len)
    paged_decode_step(params, cfg, arena, block_table, positions, tokens)
Both paged hooks return (arena, logits (b, vocab)); sampling belongs to
the serving step (serve/serve_step.py).
"""
from __future__ import annotations

from repro_torch.models import hybrid, moe, transformer
from repro_torch.models.config import ModelConfig

FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "hybrid": hybrid,
}

# families of the reference not ported yet (ROADMAP.md queue A item 10)
_LATER = ("ssm", "encoder", "vlm")


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
