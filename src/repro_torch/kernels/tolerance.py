"""How closely a kernel must agree with its plain version.

Element by element, along each output row (the last axis: one query
row's head_dim, or one batch row's heads for the partials' m and l):

    |kernel - plain| <= rtol * |plain| + atol * max |plain row|

bf16: p is rounded to bf16 for the PV product in one version and not
the other, and both round the output to bf16 once.  The CUDA-core
kernels (paged decode and prefill with int8/fp8 pages) keep p in f32
where the plain version rounds it; with bf16 pages under f32 q (an f32
model over a bf16 arena) they round as the plain version does (the
normalized p and the output to bf16) and are held at bf16's bound plus
`MAX_DIFFERENT_SHARE` (below); the tensor-core bf16 paged decode
and prefill kernels round p to bf16, as the TPU kernel rounds p to V's
type, also under `partials`, where the plain version keeps p in f32.  The output
rounding is at most an ulp (a relative 2**-7 < rtol); p's rounding
moves an element by up to 2**-9 of the terms it sums, which can exceed
|plain| where they cancel, so `atol` is scaled by the row.  The scores
are f32 in every version (the TPU kernel's f32 dot).
A row that averages hundreds of tokens (|out| ~ 0.05) is thus held as
tightly as a row of one token (|out| ~ 3), and a table that reads one
page twice fails the check (tests/test_torch_kernels.py).  f32: the
same sums in another order.  The flash backward's dQ, dK and dV rows
are held by the same rule plus a floor (`grad_floor`).
"""
from __future__ import annotations

import torch

# q dtype -> (rtol, atol relative to the row's largest |plain|)
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


# the flash backward's floor, relative to its head's largest |plain|
GRAD_FLOOR = 1e-5

# bf16 pages under f32 q: the kernel rounds as its plain version does,
# so both give the same bf16 values except where f32 sums in another
# order land on the other side of a rounding boundary.  At most this
# share of the elements may differ; a kernel that rounded q or the
# scores to bf16 changes about half of them (tests/test_torch_kernels.py).
MAX_DIFFERENT_SHARE = 0.02


def different_share(got, want) -> float:
    """The share of the elements of `got` that differ from `want`'s."""
    return (got.float() != want.float()).float().mean().item()


def worst_ratio(got, want, rtol: float, atol: float,
                floor=None) -> tuple[float, float]:
    """(max |got - want|, max over elements of |got - want| / bound) over
    a tensor or a tuple of tensors (the partials), with the bound above
    plus floor(plain) where a `floor` is given (`grad_floor`).  The two
    agree when the ratio is at most 1; with no floor, an element that
    must be exactly zero (a row of zeros) fails on any difference."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = g.float(), w.float()
        d = torch.nan_to_num((g - w).abs(), nan=float("inf"))   # NaN fails
        bound = rtol * w.abs() + atol * w.abs().amax(-1, keepdim=True)
        if floor is not None:
            bound = bound + floor(w)
        r = torch.where(d == 0, torch.zeros_like(d), d / bound)
        err = max(err, d.max().item())
        ratio = max(ratio, r.max().item())
    return err, ratio


def grad_floor(w):
    """GRAD_FLOOR x the largest |w| of each (batch row, head) of an
    attention gradient w (b, s, h, d), the flash backward's floor.

    The backward's rows (one query's dQ, one key's dK or dV) are held as
    the forward's are, by their own largest |plain|.  But they are sums
    dS K and dS^T Q whose terms dS = P (dP - D) cancel: a query that sees
    one key has dS = 0 up to the f32 rounding of dP and D, which are
    summed in different orders (the kernel's tiles, its D pass, the plain
    version's einsums), in bf16 as in f32.  Its dQ row is then ~1e-7 of
    noise where the plain version may give exact zeros.  That noise
    scales with the head's |dO| |V| |K|, not with the row's own cancelled
    size, hence a floor 1e-5 of the head's largest |plain|, no larger
    than a late row's own atol at 2,048 tokens: a dropped query step or
    key tile still fails (tests/test_torch_flash_backward.py,
    benchmarks/flash_bwd_mutants.py)."""
    return GRAD_FLOOR * w.abs().amax(dim=(1, 3), keepdim=True)
