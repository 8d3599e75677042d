"""Elastic scaling: the batch plan of a run resumed on another device
count.

Port of `repro.train.elastic`.  Checkpoints store full, unsharded
arrays in the reference's layout (`train/checkpoint.py`; rank 0 of a
sharded run writes them from gathered shards, `train_step.save_sharded`),
and the GLOBAL batch is the contract: when the data-parallel width
changes, `elastic_plan` recomputes the per-device batch and the gradient
accumulation so that `global_batch = dp_width * per_device_batch *
grad_accum` still holds; the step-indexed learning-rate schedule stays
aligned through the restored `step`.  `elastic_restore` places a
checkpoint on a new mesh: each rank keeps its shard of every leaf under
the new mesh's `state_shardings`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.train.checkpoint import CheckpointManager, _to_tensor
from repro_torch.train.train_step import (TrainState, state_shapes,
                                          state_shardings)
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import named_groups, tree_leaves, \
    tree_unflatten_with_names

log = get_logger("elastic")


class ElasticError(RuntimeError):
    pass


@dataclass(frozen=True)
class ElasticPlan:
    global_batch: int
    dp_width: int                 # data-parallel width (pod*data axes)
    per_device_batch: int
    grad_accum: int

    @property
    def device_batch_total(self) -> int:
        return self.dp_width * self.per_device_batch


def elastic_plan(global_batch: int, dp_width: int,
                 max_per_device_batch: int = 0) -> ElasticPlan:
    """Pick (per_device_batch, grad_accum) preserving the global batch.

    Strategy: largest per-device batch that divides cleanly (optionally
    capped by memory via `max_per_device_batch`), remainder becomes grad
    accumulation.  Raises if global_batch is not divisible by dp_width.
    """
    if global_batch % dp_width != 0:
        raise ElasticError(
            f"global_batch {global_batch} not divisible by dp width {dp_width}; "
            f"choose a different mesh or pad the batch")
    per_dp = global_batch // dp_width
    pdb = per_dp if not max_per_device_batch else min(per_dp, max_per_device_batch)
    while per_dp % pdb != 0:
        pdb -= 1
    return ElasticPlan(
        global_batch=global_batch, dp_width=dp_width,
        per_device_batch=pdb, grad_accum=per_dp // pdb,
    )


def elastic_restore(mgr: CheckpointManager, cfg, optimizer, mesh,
                    step: int | None = None, rules=None, device=None):
    """Restore a TrainState onto `mesh` (any shape).  Returns (state,
    manifest).  On a bound mesh of several positions each rank keeps its
    shard of every leaf under the mesh's `state_shardings`, on its own
    device; on one position (`mesh` None or of size 1) the full state, on
    `device` (None: the mesh's device, else CUDA).  Every parameter
    requires grad."""
    shapes = state_shapes(cfg, optimizer)
    arrays, manifest = mgr.restore_arrays(step)
    dtypes = {n: v["dtype"] for n, v in manifest["leaves"].items()}
    if mesh is not None and mesh.size > 1:
        sh = state_shardings(cfg, optimizer, mesh, rules, shapes=shapes)
        by_name = {n: parts[0] for n, parts, _ in named_groups(sh)}
        coords, dev = mesh.my_coords, mesh.device
    else:
        by_name, coords = {}, None
        dev = device if device is not None else (
            mesh.device if mesh is not None and mesh.devices else None)
        if dev is None:
            from repro_torch.utils.device import resolve_device
            dev = resolve_device(None)

    def leaf(a, ref, name):
        s = by_name.get(name)
        if s is not None and isinstance(ref, torch.Tensor):
            a = a[s.slices(a.shape, coords)]
        return _to_tensor(a, dtypes.get(name, str(a.dtype)), ref, dev)
    state = tree_unflatten_with_names(shapes, arrays, fn=leaf)
    for p in tree_leaves(state.params):
        p.requires_grad_(True)
    saved_mesh = manifest.get("metadata", {}).get("mesh")
    log.info("elastic restore: step=%s saved_mesh=%s -> new mesh %s",
             manifest["step"], saved_mesh,
             dict(mesh.shape) if mesh is not None else None)
    return TrainState(step=int(state.step), params=state.params,
                      opt_state=state.opt_state), manifest
