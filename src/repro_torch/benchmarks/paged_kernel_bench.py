"""Beyond-paper: the paged-attention kernels against their plain versions.

Port of the reference's `benchmarks/paged_kernel_bench.py`.  Times the
port's paged decode and chunk-prefill ops (on a CUDA tensor the
hand-written kernels of `kernels/csrc/paged_attention.cu` and
`paged_prefill.cu`; on the CPU the ops take their plain versions)
against the plain PyTorch versions (`paged_*_attention_plain`), and
checks parity on every geometry.  VERIFY_GEOMS times the
speculative-decode verify walk: one (k+1)-token ragged prefill call
against the k+1 sequential decode calls it replaces (its `ref ms`
column), with parity between the two.  QUANT_GEOMS reruns a subset with
int8/fp8 pages and per-token scale columns: the in-kernel dequant
against the dequantizing plain version.  PASS is parity; the timings
ride along (CUDA events on the card, `perf_counter` on the CPU).

The inputs are the reference's: the same `np.random.default_rng(0)`
draws in its order, so every row sees the tensors the reference's row
sees.  The f32 gate is the reference's `allclose(rtol=1e-5,
atol=1e-5)`.  `run(extra_geoms=...)` appends bf16 geometries (decode,
prefill and the verify walk at one width each, from the same stream
of draws), held element by element under `kernels/tolerance.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.paged_kernel_bench \\
        [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.core.unimem import quantize_kv
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_prefill.ops import (
    paged_prefill_attention, paged_prefill_attention_plain)
from repro_torch.kernels.tolerance import TOLERANCE, worst_ratio
from repro_torch.utils.device import resolve_device

# (hq, hkv, hd, page, max_pages, pages_per_block) — one sub-tile GQA
# geometry, one multi-page-block, one exact-MXU-tile (pages_per_block is
# the TPU grid's knob: the CUDA kernels do not read it)
GEOMS = [
    (4, 2, 16, 8, 4, 1),
    (8, 2, 64, 8, 4, 2),
    (8, 8, 128, 8, 2, 2),
]
# speculative verify: one (k+1)-token ragged prefill call (how the
# engine scores a draft window) vs the k+1 sequential decode calls it
# replaces — (k, hq, hkv, hd, page, max_pages, ppb).  Chunk row j
# attends kv_pos <= start+j, decode at position start+j attends the
# same set, so the row also pins the verify-walk/decode equivalence the
# accept rule relies on.
VERIFY_GEOMS = [
    (2, 8, 2, 64, 8, 4, 2),
    (4, 8, 2, 64, 8, 4, 2),
    (4, 8, 8, 128, 8, 2, 2),
]
# quantized reruns: in-kernel dequant vs the dequantizing plain version,
# one sub-tile and one wider geometry per storage dtype
QUANT_GEOMS = [
    ("int8", 4, 2, 16, 8, 4, 1),
    ("int8", 8, 2, 64, 8, 4, 2),
    ("fp8", 4, 2, 16, 8, 4, 1),
    ("fp8", 8, 2, 64, 8, 4, 2),
]
QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# extra_geoms' dtypes: (dtype tag, hq, hkv, hd, page, max_pages, k)
EXTRA_DTYPES = {"bf16": torch.bfloat16}
B, CHUNK, REPS = 2, 8, 3
CUDA_REPS = 20              # back-to-back calls a CUDA-event timing averages
F32_GATE = dict(rtol=1e-5, atol=1e-5)


def _time(fn, device) -> float:
    """Mean ms of one call of fn() after a warm call: CUDA events over
    CUDA_REPS calls on the card, `perf_counter` over REPS on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CUDA_REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / CUDA_REPS


def _f32(rng, shape, device, dtype=torch.float32):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device).to(dtype))


def _i32(a, device):
    return torch.from_numpy(np.asarray(a, np.int32)).to(device)


def _setup(rng, hkv, hd, page, mp, device=torch.device("cpu"),
           dtype=torch.float32):
    """The reference's arena draw: K/V pages (B * mp + 1, page, hkv, hd)
    and a (B, mp) table of distinct pages, never the last one."""
    P = B * mp + 1
    k = _f32(rng, (P, page, hkv, hd), device, dtype)
    v = _f32(rng, (P, page, hkv, hd), device, dtype)
    bt = _i32(rng.permutation(P - 1)[:B * mp].reshape(B, mp), device)
    return k, v, bt


def cases(rng, device=torch.device("cpu"), extra_geoms=()):
    """Every row's inputs, drawn from `rng` in the reference's order
    (then the `extra_geoms`): dicts with "kernel" (decode, prefill or
    verify), "geom", "dtype" and "args", the op's positional tensors
    (decode: q, k, v, bt, pos; prefill and verify: q, k, v, bt, start,
    clen), and "scales" (k_scale, v_scale) or None."""
    device = torch.device(device)

    def decode_prefill(tag, dt, hq, hkv, hd, page, mp, k, v, bt, scales,
                       geom):
        q = _f32(rng, (B, hq, hd), device, dt)
        pos = _i32(rng.integers(0, mp * page, B), device)
        yield dict(kernel="decode", geom=geom, dtype=tag,
                   args=(q, k, v, bt, pos), scales=scales)
        qc = _f32(rng, (B, CHUNK, hq, hd), device, dt)
        start = _i32(rng.integers(0, mp * page - CHUNK, B), device)
        clen = _i32([CHUNK - 3, CHUNK], device)        # ragged tail
        yield dict(kernel="prefill", geom=geom, dtype=tag,
                   args=(qc, k, v, bt, start, clen), scales=scales)

    def verify(tag, dt, spec_k, hq, hkv, hd, page, mp, geom):
        r = spec_k + 1
        k, v, bt = _setup(rng, hkv, hd, page, mp, device, dt)
        qc = _f32(rng, (B, r, hq, hd), device, dt)
        start = _i32(rng.integers(0, mp * page - r, B), device)
        clen = _i32(np.full((B,), r), device)
        yield dict(kernel="verify", geom=geom, dtype=tag,
                   args=(qc, k, v, bt, start, clen), scales=None)

    for hq, hkv, hd, page, mp, ppb in GEOMS:
        k, v, bt = _setup(rng, hkv, hd, page, mp, device)
        yield from decode_prefill(
            "f32", torch.float32, hq, hkv, hd, page, mp, k, v, bt, None,
            f"hq{hq}/hkv{hkv}/hd{hd}/page{page}x{mp}/ppb{ppb}")
    for spec_k, hq, hkv, hd, page, mp, ppb in VERIFY_GEOMS:
        yield from verify("f32", torch.float32, spec_k, hq, hkv, hd, page,
                          mp, f"k{spec_k}/hq{hq}/hkv{hkv}/hd{hd}/"
                              f"page{page}x{mp}")
    for tag, hq, hkv, hd, page, mp, ppb in QUANT_GEOMS:
        k, v, bt = _setup(rng, hkv, hd, page, mp, device)
        qk, ks = quantize_kv(k, QUANT_DTYPES[tag])
        qv, vs = quantize_kv(v, QUANT_DTYPES[tag])
        yield from decode_prefill(
            tag, torch.float32, hq, hkv, hd, page, mp, qk, qv, bt,
            (ks.contiguous(), vs.contiguous()),
            f"{tag}/hq{hq}/hkv{hkv}/hd{hd}/page{page}x{mp}/ppb{ppb}")
    for tag, hq, hkv, hd, page, mp, spec_k in extra_geoms:
        dt = EXTRA_DTYPES[tag]
        k, v, bt = _setup(rng, hkv, hd, page, mp, device, dt)
        yield from decode_prefill(
            tag, dt, hq, hkv, hd, page, mp, k, v, bt, None,
            f"{tag}/hq{hq}/hkv{hkv}/hd{hd}/page{page}x{mp}")
        yield from verify(tag, dt, spec_k, hq, hkv, hd, page, mp,
                          f"{tag}/k{spec_k}/hq{hq}/hkv{hkv}/hd{hd}/"
                          f"page{page}x{mp}")


def calls(case):
    """(kernel side, plain side) of a case as zero-argument callables:
    the op against its plain version, or for a verify row one prefill
    call against the k+1 decode calls it replaces (stacked on axis 1)."""
    args = case["args"]
    ks, vs = case["scales"] or (None, None)
    if case["kernel"] == "decode":
        return (lambda: paged_decode_attention(*args, k_scale=ks, v_scale=vs),
                lambda: paged_decode_attention_plain(*args, k_scale=ks,
                                                     v_scale=vs))
    if case["kernel"] == "prefill":
        return (lambda: paged_prefill_attention(*args, k_scale=ks,
                                                v_scale=vs),
                lambda: paged_prefill_attention_plain(*args, k_scale=ks,
                                                      v_scale=vs))
    qc, k, v, bt, start, _ = args
    rows = [(qc[:, j].contiguous(), start + j) for j in range(qc.shape[1])]
    return (lambda: paged_prefill_attention(*args),
            lambda: torch.stack([paged_decode_attention(q, k, v, bt, pos)
                                 for q, pos in rows], dim=1))


def run(device=None, extra_geoms=()) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        build.library()                   # built and loaded before the clock
    rows, ok = [], True
    for case in cases(np.random.default_rng(0), device, extra_geoms):
        kern, ref = calls(case)
        got, want = kern(), ref()
        dt = case["args"][0].dtype
        err, ratio = worst_ratio(got, want, *TOLERANCE[dt])
        if dt == torch.float32:
            match = bool(torch.allclose(got, want, **F32_GATE))
        else:
            match = ratio <= 1.0
        ok &= match
        rows.append(dict(kernel=case["kernel"], geom=case["geom"],
                         dtype=case["dtype"], match=match,
                         max_abs_err=err, worst_err_over_bound=ratio,
                         kernel_ms=_time(kern, device),
                         ref_ms=_time(ref, device)))
    return {"name": "paged_kernel_bench", "ok": bool(ok), "rows": rows,
            "device": str(device)}


def pretty(result: dict):
    print(f"== Paged kernels vs their plain versions on "
          f"{result['device']} (parity gate; ms) ==")
    print(f"{'kernel':>8}  {'geometry':<34}{'kernel ms':>11}{'ref ms':>9}"
          "  parity")
    for r in result["rows"]:
        print(f"{r['kernel']:>8}  {r['geom']:<34}{r['kernel_ms']:>11.3f}"
              f"{r['ref_ms']:>9.3f}  {'==' if r['match'] else 'DIFFER'}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} "
          "(kernel == plain version on every geometry)\n")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    res = run(ap.parse_args(argv).device)
    pretty(res)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
