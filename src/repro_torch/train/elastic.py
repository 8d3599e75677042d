"""Elastic scaling: the batch plan of a run resumed on another device
count.

Port of the arithmetic of `repro.train.elastic` (`ElasticPlan`,
`elastic_plan`).  Checkpoints store full, unsharded arrays, and the
GLOBAL batch is the contract: when the data-parallel width changes,
`elastic_plan` recomputes the per-device batch and the gradient
accumulation so that `global_batch = dp_width * per_device_batch *
grad_accum` still holds; the step-indexed learning-rate schedule stays
aligned through the restored `step`.  `elastic_restore`, which places a
checkpoint on a new mesh, needs process groups and goes with sharded
training (ROADMAP.md queue A, A.6 part two (item 12)).
"""
from __future__ import annotations

from dataclasses import dataclass


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
