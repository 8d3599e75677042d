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

`lowered_sharded_hlo` is the counterpart of the reference's
compiled-HLO probe: the `launch/trace.py` Trace of one sharded step
call, whose collective records hold every `collectives.hand` (a bank's
inputs and summaries crossing to and from the lead device).
"""
from __future__ import annotations

import torch

from repro_torch.launch import trace as T
from repro_torch.launch.mesh import MEM_AXIS, MemMesh
from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.sampling import SamplingState
from repro_torch.serve.serve_step import (make_paged_serve_fns,
                                          make_paged_verify_fn,
                                          trace_second_call)


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


def lowered_sharded_hlo(cfg: ModelConfig, mesh: MemMesh, which: str = "decode",
                        *, max_batch: int = 2, max_seq: int = 64,
                        page_size: int = 8, prefill_chunk: int = 8,
                        params=None, sampling: SamplingState | None = None,
                        device=None) -> T.Trace:
    """The Trace of one call of the SHARDED serving step (`which` in
    {"decode", "prefill"}) on a fresh `ShardedPagedKVArena` over `mesh`,
    led from `device` (default the mesh's first).  The interconnect
    contract reads its collective records: every `hand` between a bank
    and the lead device is summary-sized (no page-sized tensor crosses),
    and `Trace.output`'s tokens are int32, not logits.  The traced call
    is the second (see `serve_step.lowered_paged_hlo`)."""
    from repro_torch.serve.sharded.arena import ShardedPagedKVArena

    device = torch.device(device) if device is not None else mesh.devices[0]
    n = mesh.shape[MEM_AXIS]
    num_pages = -(-max_batch * max_seq // page_size // n) * n
    arena = ShardedPagedKVArena(cfg, num_pages=num_pages,
                                page_size=page_size, device=device,
                                max_batch=max_batch, mesh=mesh)
    return trace_second_call(
        cfg, which, make_sharded_serve_fns(cfg, mesh, num_pages,
                                           device=device),
        arena.kv, device, params=params, sampling=sampling,
        max_batch=max_batch, max_seq=max_seq, page_size=page_size,
        prefill_chunk=prefill_chunk)
