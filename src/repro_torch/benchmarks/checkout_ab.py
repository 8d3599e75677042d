"""Time checkouts of this repository in turns on one card: the paged
attention kernels (decode and prefill), the kernels of contiguous
serving (flash attention, split-KV decode and its combine), the MoE and
SSD kernels (grouped matmul, SSD intra-chunk), both serving paths of
internlm2-1.8b, qwen3-moe-30b-a3b's grouped serve, and the SSD kernel's
serves (zamba2-2.7b and mamba2-130m, `ssd_impl="pallas"`).

    python3 src/repro_torch/benchmarks/checkout_ab.py ROOT [ROOT ...]
    python3 src/repro_torch/benchmarks/checkout_ab.py --serve serve_moe \
        ROOT [ROOT ...]
    python3 src/repro_torch/benchmarks/checkout_ab.py --ssd-bwd ROOT [ROOT ...]
    python3 src/repro_torch/benchmarks/checkout_ab.py --flash-bwd ROOT [ROOT ...]
    python3 src/repro_torch/benchmarks/checkout_ab.py --grouped-bwd ROOT [ROOT ...]

Each ROOT is a checkout of the repository: the parent commit unpacked
with `git archive` into a directory that `.gitignore` lists, say, and
`.`.  The roots run in the order given, each in a process of its own, so
give them in turns (parent, change, change, parent).  Each process
imports its ROOT's `chip_smoke.py` and `src/`, builds that checkout's
kernels, and runs chip_smoke's phases `kernels` (paged decode and
prefill), `moe_ssd_kernels` (grouped matmul, SSD), `contig_kernels`
(split-KV decode, flash), `serve` and `serve_contiguous` (internlm2-1.8b
at full depth, paged and contiguous), `serve_moe` (qwen3-moe-30b-a3b,
`moe_dispatch="grouped"`), `serve_hybrid` (zamba2-2.7b) and `serve_ssm`
(mamba2-130m), which print their JSON lines as in chip_smoke, and
times ROOT's paged
decode kernel at the main path in every dtype pair it takes (chip_smoke
times only bf16 with bf16), on the card and on the host.  Then it prints
one line {"ab": ROOT, ...}: the card, ptxas's report of the bf16
tensor-core attention kernels, of the bf16 grouped-matmul kernel and of
the bf16 SSD kernel (parsed by this checkout's `chip_smoke.tc_ptxas`,
`grouped_ptxas` and `ssd_ptxas`;
empty where ROOT's library was already built), the kernel times and
each serve's step times and peak memory.  `--serve P[,P...]` runs only
the serve phases named (no kernel phase, no decode routes) in each
root.  `--ssd-bwd` runs only ROOT's SSD intra-chunk backward at its
chip_smoke's `SSD_BWD_CASES` in bf16 (`ssd_backward_times`: held to the
plain version, timed as chip_smoke times it), with ptxas's report of
the backward's bf16 kernels.  `--flash-bwd` runs only ROOT's bf16 flash
backward at its chip_smoke's `TRAIN_FLASH_CASES` (`flash_backward_times`:
held to the plain version as chip_smoke holds it, timed as chip_smoke
times it, and each pass's device time from torch.profiler, which needs
no per-pass entry point in ROOT), with ptxas's report of the bf16
attention kernels.  `--grouped-bwd` runs only ROOT's bf16 grouped-matmul
backward at its chip_smoke's `GROUPED_BWD_CASES` (`grouped_backward_times`:
held to the plain version as chip_smoke holds it, timed as chip_smoke
times it, each pass's device time from torch.profiler and, where ROOT's
ops.py has `backward_pass_timer`, each pass launched alone), with
ptxas's report of the backward's kernels.  Needs one CUDA card; exits
nonzero when a root's phases fail.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[3]       # this checkout's root


def _this_chip_smoke():
    """This checkout's chip_smoke.py, loaded apart from ROOT's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_routes(torch, cs, dev, calls: int = 500) -> dict:
    """ROOT's paged decode kernel at chip_smoke's main-path geometry in
    every dtype pair it takes: the device time (CUDA-event medians, L2
    flushed, as chip_smoke times) and the host's, `enqueue_us`: the mean
    wall time of one call over `calls` calls made back to back without a
    synchronise (the wrapper's checks and the launch, which serving pays
    once per attention layer)."""
    from repro_torch.kernels.paged_attention import ops as pa
    kb = cs.KernelBench(torch, dev)
    out = {}
    for qdt, kvdt in ((torch.bfloat16, torch.bfloat16),
                      (torch.float32, torch.float32),
                      (torch.bfloat16, torch.int8),
                      (torch.bfloat16, torch.float8_e4m3fn)):
        kp, vp, ks, vs = kb.pages(kvdt)
        q = kb.q((kb.b, kb.hq, kb.d), qdt)

        def call():
            return pa.paged_decode_attention(q, kp, vp, kb.bt, kb.positions,
                                             k_scale=ks, v_scale=vs)
        ms = cs.time_ms(call, kb.flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        enqueue_us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        out[f"paged_decode {qdt} q, {kvdt} pages"] = {
            "ms": ms, "enqueue_us": enqueue_us}
    return out


def ssd_backward_times(torch, cs, dev) -> dict:
    """ROOT's `ssd_intra_chunk_backward` at ROOT's chip_smoke
    `SSD_BWD_CASES` with bf16 x, B and C, the inputs drawn from the
    distributions `family_backward_kernels` draws them from: each case held to
    the plain version by `BWD_TOLERANCE`, then timed as chip_smoke times
    it (CUDA events, median of 10 after 2 warm-up calls, L2 flushed)."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tolerance import worst_ratio
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev).zero_
    gdev = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for label, bh, nc, l, p, n in cs.SSD_BWD_CASES:
        heads = bh // (4 if label == "mamba2-130m" else 2)
        x = torch.randn(bh, nc, l, p, generator=gdev, device=dev)
        B = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        C = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        dt = torch.rand(bh, nc, l, generator=gdev, device=dev) * 0.1
        A = (-torch.linspace(1.0, 16.0, heads, device=dev)).repeat(
            bh // heads)
        dy = torch.randn(bh, nc, l, p, generator=gdev, device=dev)
        ds = torch.randn(bh, nc, n, p, generator=gdev, device=dev)
        args = (x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), dy, ds)
        got = ssd.ssd_intra_chunk_backward(*args)
        want = ssd.ssd_intra_chunk_backward_plain(*args)
        ratio = max(worst_ratio(g, w, *ssd.BWD_TOLERANCE)[1]
                    for g, w in zip(got, want))
        if not ratio <= 1.0:
            raise SystemExit(f"checkout_ab: ssd backward {label} disagrees "
                             f"with its plain version: err / bound {ratio}")
        del got, want
        out[f"ssd_intra_chunk_backward {label}"] = {
            "ms": cs.time_ms(lambda: ssd.ssd_intra_chunk_backward(*args),
                             flush, iters=10, warmup=2),
            "worst_err_over_bound": ratio}
        del x, B, C, dt, dy, ds, args
        torch.cuda.empty_cache()
    return out


# the flash backward's kernels by a substring of their demangled names,
# in the order tried: the D pass, the group split's reduce, dK/dV, dQ
FLASH_BWD_PASSES = (("dsum", "D"), ("reduce", "reduce"), ("dkdv", "dkdv"),
                    ("dq_", "dq"))


# the grouped backward's kernels likewise: the rounding of dY, dX, dW
GROUPED_BWD_PASSES = (("round_dy", "round"), ("dx_", "dx"), ("dw_", "dw"))


def pass_split(torch, fn, calls: int = 5, passes=FLASH_BWD_PASSES) -> dict:
    """Device ms per call of each backward pass of fn(), from
    torch.profiler over `calls` calls (`passes`: substrings of the
    kernels' names and the passes they stand for)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, name in passes:
            if key in e.key:
                out[name] = out.get(name, 0.0) \
                    + e.self_device_time_total / 1e3 / calls
                break
    return out


def flash_backward_times(torch, cs, dev) -> dict:
    """ROOT's bf16 `flash_attention_backward` at ROOT's chip_smoke
    `TRAIN_FLASH_CASES`, inputs drawn as `phase_train_kernels` draws them:
    each case held to the plain version (`TOLERANCE` with `grad_floor`,
    per row) with a bit-identical rerun, then timed as chip_smoke times
    it (CUDA events, median of 10 after 2 warm-up calls, L2 flushed),
    and split by pass (`pass_split`)."""
    from repro_torch.kernels.flash_attention import ops as fk
    from repro_torch.kernels.tolerance import (TOLERANCE, grad_floor,
                                               worst_ratio)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev).zero_
    g = torch.Generator(device=dev).manual_seed(24)
    rtol, atol = TOLERANCE[torch.bfloat16]
    out = {}
    for b, sq, skv, hq, hkv, d, causal, off, label in cs.TRAIN_FLASH_CASES:
        q, k, v, do = (torch.randn(*s, generator=g, device=dev).bfloat16()
                       for s in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d), (b, sq, hq, d)))
        kw = dict(causal=causal, q_offset=off)
        o, lse = fk.flash_attention_lse(q, k, v, **kw)
        po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
        got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
        want = fk.flash_attention_backward_plain(q, k, v, po, do, plse, **kw)
        ratio = max(worst_ratio(x, y, rtol, atol, floor=grad_floor)[1]
                    for x, y in zip(got, want))
        again = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
        if not ratio <= 1.0 or not all(
                torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit(f"checkout_ab: flash backward {label}: err / "
                             f"bound {ratio}, or a rerun gives other bits")
        del got, want, again, po, plse

        def call():
            return fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
        out[f"flash_attention_backward {label}"] = {
            "ms": cs.time_ms(call, flush, iters=10, warmup=2),
            "passes_ms": pass_split(torch, call), "d": d,
            "worst_err_over_bound": ratio}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def grouped_backward_times(torch, cs, dev) -> dict:
    """ROOT's bf16 `grouped_matmul_backward` at ROOT's chip_smoke
    `GROUPED_BWD_CASES`, with qwen3's training microbatch's live rows
    from a routing draw and the inputs drawn as `family_backward_kernels`
    draws them: each case held to the plain version (`TOLERANCE` plus
    `bf16_rounding`) with a bit-identical rerun, then timed as chip_smoke
    times it (CUDA events, median of 10 after 2 warm-up calls, L2
    flushed) and split by pass: device ms from torch.profiler
    (`pass_split`), and each pass launched alone where ROOT has
    `backward_pass_timer`."""
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.tolerance import worst_ratio
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev).zero_
    gen = torch.Generator(device="cpu").manual_seed(25)
    gdev = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16
    E, k, C = 128, 8, cs.TRAIN_MOE_CAPACITY
    live = torch.clamp(cs.routed_rows(torch, E, cs.TRAIN_MOE_TOKENS, k, gen),
                       max=C).to(dev)
    out = {}
    for K, F, label in cs.GROUPED_BWD_CASES:
        mask = (torch.arange(C, device=dev)[None, :]
                < live[:, None].long())[..., None]
        x = (torch.randn(E, C, K, generator=gdev, device=dev) * mask).to(bf16)
        w = (torch.randn(E, K, F, generator=gdev, device=dev) * 0.02).to(bf16)
        dy = torch.randn(E, C, F, generator=gdev, device=dev) * mask
        got = gm.grouped_matmul_backward(x, w, dy, live)
        want = gm.grouped_matmul_backward_plain(x, w, dy, live)
        ratio = max(worst_ratio(g, w_, *gm.TOLERANCE[bf16],
                                floor=gm.bf16_rounding)[1]
                    for g, w_ in zip(got, want))
        again = gm.grouped_matmul_backward(x, w, dy, live)
        if not ratio <= 1.0 or not all(
                torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"checkout_ab: grouped backward {label}: err / "
                             f"bound {ratio}, or a rerun gives other bits")
        del got, want, again

        def call():
            return gm.grouped_matmul_backward(x, w, dy, live)
        row = {"ms": cs.time_ms(call, flush, iters=10, warmup=2),
               "passes_ms": pass_split(torch, call,
                                       passes=GROUPED_BWD_PASSES),
               "K": K, "F": F, "live_rows": int(live.sum()),
               "worst_err_over_bound": ratio}
        if hasattr(gm, "backward_pass_timer"):
            passes = gm.backward_pass_timer(x, w, dy, live)
            row["passes_alone_ms"] = {
                name: cs.time_ms(fn, flush, iters=10, warmup=2)
                for name, fn in passes.items()}
            del passes
        out[f"grouped_matmul_backward {label}"] = row
        del x, w, dy, mask
        torch.cuda.empty_cache()
    return out


SERVES = ("serve", "serve_contiguous", "serve_moe", "serve_hybrid",
          "serve_ssm")


def run_one(root: Path, serves=SERVES, only: str = "") -> dict:
    """ROOT's phases on the card (every kernel phase when `serves` is all
    of SERVES, else only the serve phases named; with `only` "ssd-bwd",
    "flash-bwd" or "grouped-bwd" only that backward's times); returns
    the summary line."""
    here = _this_chip_smoke()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild

    if not torch.cuda.is_available():
        raise SystemExit("checkout_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = kbuild.library()
    build_s = time.perf_counter() - t0
    if only == "ssd-bwd":
        return {"ab": str(root), "card": card, "build_s": build_s,
                "ssd_bwd_ptxas": here.ssd_bwd_ptxas(lib.compiler_log),
                "times": ssd_backward_times(torch, cs, dev)}
    if only == "flash-bwd":
        report = here.tc_ptxas(lib.compiler_log)
        return {"ab": str(root), "card": card, "build_s": build_s,
                "flash_bwd_ptxas": {k: v for k, v in report.items()
                                    if k.startswith("flash_bwd")},
                "times": flash_backward_times(torch, cs, dev)}
    if only == "grouped-bwd":
        return {"ab": str(root), "card": card, "build_s": build_s,
                "grouped_bwd_ptxas": here.grouped_bwd_ptxas(lib.compiler_log),
                "times": grouped_backward_times(torch, cs, dev)}
    timings, moe, contig, routes = {}, {}, {}, {}
    if tuple(serves) == SERVES:
        timings = cs.phase_kernels(torch, dev, card)
        flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        moe = cs.phase_moe_ssd_kernels(torch, dev, card, flush_buf.zero_)
        contig = cs.phase_contig_kernels(torch, dev, card, flush_buf.zero_)
        del flush_buf
        routes = decode_routes(torch, cs, dev)
    steps = {}
    real_emit = cs.emit

    def keep(obj):
        if obj.get("phase") in SERVES:
            steps[obj["phase"]] = dict(
                wall_s=obj["wall_s"], rerun_wall_s=obj["rerun_wall_s"],
                step_s=obj["step_s"], prefill_calls=obj["prefill_calls"],
                decode_calls=obj["decode_calls"], launches=obj["launches"],
                max_memory_allocated=obj["max_memory_allocated"])
        real_emit(obj)

    cs.emit = keep
    dense = get_arch("internlm2-1.8b").model
    phases = {
        "serve": lambda: cs.phase_serve(torch, dev, card, "serve", dense),
        "serve_contiguous": lambda: cs.phase_serve(
            torch, dev, card, "serve_contiguous", dense,
            layout="contiguous"),
        "serve_moe": lambda: cs.phase_serve(
            torch, dev, card, "serve_moe",
            get_arch("qwen3-moe-30b-a3b").model.replace(
                moe_dispatch="grouped")),
        "serve_hybrid": lambda: cs.phase_serve(
            torch, dev, card, "serve_hybrid",
            get_arch("zamba2-2.7b").model.replace(ssd_impl="pallas"),
            twins=True),
        "serve_ssm": lambda: cs.phase_serve(
            torch, dev, card, "serve_ssm",
            get_arch("mamba2-130m").model.replace(ssd_impl="pallas")),
    }
    for name in serves:
        phases[name]()
    cs.emit = real_emit
    pick = ("ms", "kernel_only_ms", "combine_ms", "plain_ms", "library_ms",
            "bound_ms", "blocks", "live_blocks", "floor_ms", "enqueue_us",
            "split_and_combine_ms",
            "zero_fill_ms", "byte_ms", "kernel_ms", "layout_copies_ms",
            "xla_ms")
    times = {k: {kk: v[kk] for kk in pick if kk in v}
             for k, v in {**timings, **moe, **contig, **routes}.items()
             if k.startswith(("flash", "decode_attention", "combine",
                              "paged_prefill", "paged_decode", "grouped",
                              "moe_layer", "ssd"))}
    return {"ab": str(root), "card": card, "build_s": build_s,
            "tc_ptxas": here.tc_ptxas(lib.compiler_log),
            "grouped_ptxas": here.grouped_ptxas(lib.compiler_log),
            "ssd_ptxas": here.ssd_ptxas(lib.compiler_log),
            "times": times, **steps}


def main(argv: list[str]) -> int:
    serves = SERVES
    only = ""
    if argv[:1] in (["--ssd-bwd"], ["--flash-bwd"], ["--grouped-bwd"]):
        only, argv = argv[0][2:], argv[1:]
    if argv[:1] == ["--serve"] and len(argv) > 1:
        serves = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(serves) <= set(SERVES):
            print(f"checkout_ab: --serve takes {','.join(SERVES)}",
                  file=sys.stderr)
            return 2
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]).resolve(), serves, only)),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, __file__]
                              + ([f"--{only}"] if only else [])
                              + ["--serve", ",".join(serves), "--one", root])
        if proc.returncode != 0:
            print(f"checkout_ab: {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
