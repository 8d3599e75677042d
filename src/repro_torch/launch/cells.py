"""The rule tables and the batch and cache shardings of a training or
serving cell.

Port of the sharding part of `repro.launch.cells`: `RULE_TABLES` (an
arch's `rules` field names its table) and the logical axes of a batch's
and a cache's leaves resolved on a mesh.  The dry-run cells themselves
(`Cell`, `build_cell`, `lower_cell`, the model-FLOPs accounting) lower
XLA programs and are the paper side's XLA tools (ROADMAP.md queue A,
A.7).
"""
from __future__ import annotations

from repro_torch.distribution.sharding import (DEFAULT_RULES,
                                               SEQUENCE_PARALLEL_RULES,
                                               named_sharding,
                                               param_shardings)
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig

RULE_TABLES = {
    "default": DEFAULT_RULES,
    "seq_parallel": SEQUENCE_PARALLEL_RULES,
}

_BATCH_AXES = {
    "tokens": ("act_batch", "act_seq"),
    "labels": ("act_batch", "act_seq"),
    "frames": ("act_batch", "act_seq", None),
    "mask": ("act_batch", "act_seq"),
    "patch_embeds": ("act_batch", "act_patch", None),
}


def batch_shardings(batch_specs: dict, mesh, rules):
    """{key: NamedSharding} of a batch's leaves (anything with a
    `.shape`) on `mesh`."""
    return {
        k: named_sharding(_BATCH_AXES[k], tuple(v.shape), mesh, rules)
        for k, v in batch_specs.items()
    }


def cache_shardings(cfg: ModelConfig, cache_specs_tree, mesh, rules):
    fam = registry.get_family(cfg)
    return param_shardings(fam.cache_axes(), cache_specs_tree, mesh, rules)
