"""Sharded serving steps: the paged step closures over a banked arena.

Port of `make_sharded_serve_fns` and `make_sharded_verify_fn` of
`repro.serve.sharded.serve_step` (DESIGN.md §2).  The reference
`shard_map`s the family hooks over the mesh; the port's step is one
controller on the lead device that drives every bank.  The engine keeps
talking GLOBAL pool page ids, and the closures have the signatures of
`serve_step.make_paged_serve_fns` and `make_paged_verify_fn` (the
engine's host tables in one transfer, in-step sampling, int32 tokens
out); they run the family's paged hooks under
`cfg.replace(mem_axis=MEM_AXIS)`, which makes each layer:

  * write the new tokens' K/V into the bank that owns each page (the
    rest fall into each bank's null sink, `layers.localize_block_table`);
  * walk each bank's resident pages only, at the compacted width
    ceil(max_pages / n), with the paged kernels in partials mode on the
    bank's device (`layers._shard_local_walk`);
  * merge the (m, l, acc) summaries on the lead device through the
    combine kernel (`distribution.collectives.combine_shard_partials`).

Everything that is not attention runs once, on the lead device.  Only
the queries, the new tokens' K/V, the block table and the summaries
cross between a bank and the lead device: no page-sized tensor does.

`lowered_sharded_hlo` (the reference's compiled-HLO probe) waits for the
XLA tools (ROADMAP.md queue A, A.7).
"""
from __future__ import annotations

from repro_torch.launch.mesh import MEM_AXIS, MemMesh
from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.serve_step import (make_paged_serve_fns,
                                          make_paged_verify_fn)


def _sharded_cfg(cfg: ModelConfig, mesh: MemMesh, num_pages: int):
    n = mesh.shape[MEM_AXIS]
    if num_pages % n:
        raise ValueError(f"num_pages {num_pages} must divide over {n} shards")
    return cfg.replace(mem_axis=MEM_AXIS)


def make_sharded_serve_fns(cfg: ModelConfig, mesh: MemMesh, num_pages: int,
                           *, device=None):
    """Sharded analogues of `make_paged_serve_fns`: (prefill_chunk,
    decode) with the same signatures over a `ShardedPagedKVArena`'s kv,
    GLOBAL block tables and per-slot `SamplingState`.  `num_pages` is
    the global pool size; `device` the lead device (default the mesh's
    first)."""
    if not registry.has_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged serving path")
    return make_paged_serve_fns(_sharded_cfg(cfg, mesh, num_pages),
                                device if device is not None
                                else mesh.devices[0])


def make_sharded_verify_fn(cfg: ModelConfig, mesh: MemMesh, num_pages: int,
                           *, device=None):
    """Sharded analogue of `make_paged_verify_fn`: the verify walk runs
    per bank in partials mode and merges like prefill; accept and reject
    collapse the merged logits to int32 in the step, so the accepted
    stream is the single arena's."""
    if not registry.has_verify(cfg):
        raise ValueError(f"family {cfg.family!r} has no speculative-verify "
                         f"path")
    return make_paged_verify_fn(_sharded_cfg(cfg, mesh, num_pages),
                                device if device is not None
                                else mesh.devices[0])
