"""How closely a kernel must agree with its plain version.

Element by element, along each output row (the last axis: one query
row's head_dim, or one batch row's heads for the partials' m and l):

    |kernel - plain| <= rtol * |plain| + atol * max |plain row|

bf16: p is rounded to bf16 for the PV product in one version and not
the other, and both round the output to bf16 once.  The CUDA-core
kernels (paged decode and prefill with int8/fp8 pages) keep p in f32
where the plain version rounds it; the tensor-core bf16 paged decode
and prefill kernels round p to bf16, as the TPU kernel rounds p to V's
type, also under `partials`, where the plain version keeps p in f32.  The output
rounding is at most an ulp (a relative 2**-7 < rtol); p's rounding
moves an element by up to 2**-9 of the terms it sums, which can exceed
|plain| where they cancel, so `atol` is scaled by the row.  The scores
are f32 in every version (the TPU kernel's f32 dot).
A row that averages hundreds of tokens (|out| ~ 0.05) is thus held as
tightly as a row of one token (|out| ~ 3), and a table that reads one
page twice fails the check (tests/test_torch_kernels.py).  f32: the
same sums in another order.
"""
from __future__ import annotations

import torch

# q dtype -> (rtol, atol relative to the row's largest |plain|)
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def worst_ratio(got, want, rtol: float, atol: float) -> tuple[float, float]:
    """(max |got - want|, max over elements of |got - want| / bound) over
    a tensor or a tuple of tensors (the partials), with the bound above.
    The two agree when the ratio is at most 1; an element that must be
    exactly zero (a row of zeros) fails on any difference."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = g.float(), w.float()
        d = torch.nan_to_num((g - w).abs(), nan=float("inf"))   # NaN fails
        bound = rtol * w.abs() + atol * w.abs().amax(-1, keepdim=True)
        r = torch.where(d == 0, torch.zeros_like(d), d / bound)
        err = max(err, d.max().item())
        ratio = max(ratio, r.max().item())
    return err, ratio
