"""The near-memory attention merge of a sharded page arena.

Port of `combine_shard_partials` of `repro.distribution.collectives`
(DESIGN.md §2).  Each bank of a sharded arena computes attention over
its RESIDENT pages only and hands its online-softmax carry (m, l, acc)
to the lead device: (batch, heads(, head_dim))-sized summaries, never
pages.  There the summaries are stacked as the splits of one split-KV
merge and folded into the exact global softmax by log-sum-exp: the
combine kernel of `kernels/decode_attention` on the card
(`combine_splits_kernel`), its plain version (`combine_splits`) on the
CPU.  A bank with no resident page for a row contributes (m = -1e30,
l = 0, acc = 0), which the merge weights 0 (a row with no visible page
on any bank comes out as zeros).

`hand` is the one way a tensor moves between the lead device and a
bank, so what crosses can be counted (and, on one card, nothing moves).

The reference's int8 ring all-reduce, bucketed psums and `axis_size`
serve sharded training and wait for it (ROADMAP.md queue A, A.6 part
two).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ops import (combine_splits,
                                                      combine_splits_kernel)


def hand(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`: the same tensor where it already lies there."""
    return x.to(device, non_blocking=True)


def combine_shard_partials(m, l, acc, out_dtype, device=None):
    """Merge per-bank online-softmax partials on the lead device.

    m, l: one (..., hq) f32 tensor per bank; acc: one (..., hq, d) f32
    tensor per bank (the partials-mode output of the paged kernels over
    each bank's resident pages, any leading batch/chunk dims).  They are
    handed to `device` (default: the first bank's), stacked to (B, n,
    hq) and (B, n, hq, d), and merged as n splits.  Returns (..., hq, d)
    in `out_dtype` on `device`."""
    device = torch.device(device) if device is not None else m[0].device
    hq, d = acc[0].shape[-2:]
    lead = tuple(m[0].shape[:-1])
    B = math.prod(lead)
    mg = torch.stack([hand(x, device).reshape(B, hq) for x in m], dim=1)
    lg = torch.stack([hand(x, device).reshape(B, hq) for x in l], dim=1)
    ag = torch.stack([hand(x, device).reshape(B, hq, d) for x in acc], dim=1)
    if device.type == "cpu":
        o = combine_splits(mg, lg, ag, B, hq, d, out_dtype)
    else:
        o = combine_splits_kernel(mg, lg, ag, B, hq, d, out_dtype)
    return o.reshape(*lead, hq, d)
