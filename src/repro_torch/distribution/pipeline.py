"""GPipe pipeline parallelism over a "stage" process group.

Port of `repro.distribution.pipeline`.  Layers are split into S stages
along a "stage" mesh axis and microbatches flow through the stage ring,
the classic GPipe fill/drain schedule:

    t:      0    1    2    3   ...
    stage0  m0   m1   m2   m3
    stage1       m0   m1   m2
    stage2            m0   m1

Every rank runs the SAME loop of M + S - 1 ticks: at tick t it applies
its stage's layers to what its neighbour handed over (stage 0: to
microbatch t), and hands the result on with one send/recv of the ring
(`collectives.ring_shift`), where the reference's scan calls
`lax.ppermute`.  Bubble fraction = (S-1)/(S-1+M).  The last stage's
outputs reach every rank through one all-reduce over the stage group
(every other stage contributes zeros), as the reference's psum does.

`pipelined_forward` is the forward building block (tests, meshes
deeper than the graded ones); the graded meshes use pod-DP instead
(DESIGN.md §5).
"""
from __future__ import annotations

import torch

from repro_torch.distribution import collectives as C
from repro_torch.utils.tree import tree_leaves, tree_map


def stage_params_split(params_stacked, num_stages: int):
    """Split layer-stacked params (leading dim = num_layers) into
    (num_stages, layers_per_stage, ...): the per-stage shards."""
    def one(x):
        L = x.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers % {num_stages} stages != 0")
        return x.reshape((num_stages, L // num_stages) + tuple(x.shape[1:]))
    return tree_map(one, params_stacked)


def gpipe_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_stages - 1 + num_microbatches)


def pipelined_forward(layer_fn, stage_params, x_microbatches, mesh,
                      stage_axis: str = "stage"):
    """Run microbatches through a stage pipeline on a bound mesh.

    layer_fn: (carry_x, layer_params) -> carry_x, one LAYER (the stage
        applies its local layers in order).
    stage_params: tree with leaves (num_stages, layers_per_stage, ...);
        this rank uses its stage's entry (leaves with a leading 1 are
        taken as this rank's own already).
    x_microbatches: (num_micro, mb, ...) input microbatches, the same on
        every rank.
    Returns (num_micro, mb, ...) outputs (from the LAST stage) on every
    rank.
    """
    g = mesh.group(stage_axis)
    S, sid = g.size, g.index
    M = x_microbatches.shape[0]
    mine = tree_map(lambda a: a[0] if a.shape[0] == 1 else a[sid],
                    stage_params)
    n_local = tree_leaves(mine)[0].shape[0]

    def apply_stage(h):
        for i in range(n_local):
            h = layer_fn(h, tree_map(lambda a: a[i], mine))
        return h

    mb_shape = tuple(x_microbatches.shape[1:])
    buf = torch.zeros(mb_shape, dtype=x_microbatches.dtype,
                      device=x_microbatches.device)
    outs = torch.zeros_like(x_microbatches)
    for t in range(M + S - 1):
        if sid == 0:
            h = x_microbatches[t] if t < M else torch.zeros_like(buf)
        else:
            h = buf
        y = apply_stage(h)
        emit = t - (S - 1)
        if sid == S - 1 and emit >= 0:
            outs[emit] = y
        buf = C.ring_shift(y, g, 1, name="pipeline_send_recv")
    return C.all_reduce(outs, g, name="pipeline_outputs")
