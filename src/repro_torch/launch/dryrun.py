"""Dry-run: trace every (arch x shape x mesh) cell and write its record.

Port of `repro.launch.dryrun`.  The reference lowers and compiles each
cell on 512 placeholder devices and reads the compiled program; the
port traces one call of the cell's step (`launch/cells.py` `lower_cell`,
`launch/trace.py`) and writes one JSON per cell under
experiments/dryrun_torch/ with the reference's keys:

  * "meta", "model_flops" (`cells.model_flops`);
  * "memory_analysis": argument bytes (this device's inputs), output
    bytes, and as temp the peak of the bytes the call's own tensors hold
    at once (`Trace.peak_live_bytes`); the alias and generated-code
    sizes have no counterpart (None);
  * "cost_analysis": the trace's flops and bytes accessed;
  * "hlo": the same field names, per device, from `Trace.summary()`:
    flops (matmuls and convolutions, and the FLOPs each kernel launch
    reports), bytes read and written (eager traffic: every op not a view
    reads its operands and writes its result), collective wire bytes and
    counts by kind;
  * "trace": ops, kernel launches and FLOPs by kernel, collective bytes
    and calls by counter name (`distribution/collectives.py` `STATS`);
  * "target": "h100", the roofline constants `launch/roofline.py` uses.

On "meta" (`--device meta`) a production mesh ("single": (16, 16),
"multi": (2, 16, 16)) gives per-device shapes: a train cell is rank 0's
sharded step on dry collectives, which move nothing and count their
bytes.  On the card (`--device cuda`, the default; `--mesh one`, one
device) the cell runs for real with seeded weights, and the record adds
"measured": the step's seconds (CUDA events, the median of
`TIMED_STEPS` calls after a warm-up), the peak memory (`torch.cuda.max_memory_allocated`)
and the profiler's device time by kernel, the hand-written kernels under
their own names.  The roofline row then has its MFU.  Without a card
`--device cuda` raises.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \\
        --mesh single --device meta
    python -m repro_torch.launch.dryrun --all --mesh single --device meta
    python -m repro_torch.launch.dryrun --cells a__s b__s2 --device meta
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape decode_card --mesh one            # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import traceback

import torch

from repro_torch.configs import all_archs, applicable_cells, get_arch
from repro_torch.distribution import collectives as C
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch import trace as _trace
from repro_torch.utils.tree import tree_leaves

MESHES = {
    "single": dict(multi_pod=False),
    "multi": dict(multi_pod=True),
    "one": None,                 # one device: the card (or the CPU)
}
TIMED_STEPS = 5                  # CUDA-event timed calls of a card step


def make_mesh_named(name: str):
    """The mesh of a `MESHES` name (None: one device)."""
    kw = MESHES[name]
    return None if kw is None else make_production_mesh(**kw)


def apply_overrides(spec, overrides: dict | None):
    """`spec` with key=value overrides of its model config and its
    training settings (optimizer, train_grad_accum, rules)."""
    if not overrides:
        return spec
    model_kw = {k: v for k, v in overrides.items()
                if hasattr(spec.model, k)}
    spec_kw = {k: v for k, v in overrides.items()
               if k in ("optimizer", "train_grad_accum", "rules")}
    if model_kw:
        spec = dataclasses.replace(spec, model=spec.model.replace(**model_kw))
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    return spec


def _check_device(device: str, mesh) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='meta' "
                           "(shapes only) or 'cpu'")
    if mesh is not None and dev.type != "meta":
        raise ValueError("a production mesh is traced on 'meta' (its "
                         "per-device shapes); the card runs mesh 'one'")
    return dev


def _leaves(x) -> list:
    """Tensor leaves of a step's inputs or outputs (a TrainState's
    params and optimizer state included)."""
    if hasattr(x, "params") and hasattr(x, "opt_state"):
        return tree_leaves(x.params) + tree_leaves(x.opt_state)
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in _leaves(e)]
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _mem_dict(cell, tr) -> dict:
    """The reference's memory_analysis fields: this device's inputs, the
    outputs, as temp the peak bytes the call's own tensors held at once,
    and as alias the outputs that are inputs updated in place (the
    state a train step updates, the cache a serving step writes: what
    the reference donates)."""
    ins = {id(t) for t in _leaves(cell.args)}
    outs = _leaves(tr.output)
    return {"argument_size_in_bytes": cell.meta["argument_bytes"],
            "output_size_in_bytes": sum(_trace.nbytes(t) for t in outs),
            "temp_size_in_bytes": tr.peak_live_bytes,
            "alias_size_in_bytes": sum(_trace.nbytes(t) for t in outs
                                       if id(t) in ins),
            "generated_code_size_in_bytes": None}


def _trace_dict(tr, s) -> dict:
    flops_by_kernel: dict = {}
    for k in tr.kernels:
        flops_by_kernel[k.name] = flops_by_kernel.get(k.name, 0.0) + k.flops
    coll_bytes: dict = {}
    coll_calls: dict = {}
    for c in tr.collectives:
        coll_bytes[c.name] = coll_bytes.get(c.name, 0) + c.result_bytes
        coll_calls[c.name] = coll_calls.get(c.name, 0) + 1
    return {"ops": len(tr.ops), "kernel_launches": s.kernel_launches,
            "kernel_flops": flops_by_kernel,
            "collective_result_bytes_by_name": coll_bytes,
            "collective_calls_by_name": coll_calls,
            "top_flops_by_op": dict(sorted(
                s.flops_by_op.items(), key=lambda kv: -kv[1])[:8])}


def profile_kernels(fn, top: int = 10) -> dict:
    """One call of fn() under torch.profiler on the card: the device's
    busy seconds and the kernels taking the most device time, each under
    its own name (the hand-written ones by their C++ names)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    events.sort(key=lambda e: -e.self_device_time_total)
    return {"busy_s": busy,
            "top_kernels": [{"name": e.key[:120],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in events[:top]]}


def measure(cell) -> dict:
    """The cell's step on the card: CUDA-event seconds of `TIMED_STEPS` calls
    (after the calls already made), the peak memory of those calls, one
    profiled call."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(TIMED_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        cell.fn(*cell.args)
        b.record()
        torch.cuda.synchronize()
        secs.append(a.elapsed_time(b) / 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profile_kernels(lambda: cell.fn(*cell.args))
    return {"step_s": statistics.median(secs), "steps_s": secs,
            "peak_memory_bytes": peak,
            "device": torch.cuda.get_device_name(0), **prof}


def run_cell(arch: str, shape: str, mesh_name: str, outdir: str,
             overrides: dict | None = None, *, device="cuda") -> dict:
    """Trace (and on the card, measure) one cell; write its record
    under `outdir` (none when empty) and return it."""
    mesh = make_mesh_named(mesh_name)
    dev = _check_device(device, mesh)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "mesh_shape": dict(mesh.shape) if mesh is not None else {},
           "ok": False, "target": "h100", "device": str(device)}
    try:
        spec = apply_overrides(get_arch(arch), overrides)
        if overrides:
            rec["overrides"] = overrides
        cell = build_cell(arch, shape, mesh, spec=spec, device=dev)
        rec["meta"] = cell.meta
        rec["model_flops"] = cell.model_flops
        t_build = time.time()
        if dev.type == "cuda":
            cell.fn(*cell.args)              # warm-up: kernels, cuBLAS
            torch.cuda.synchronize()
        C.STATS.reset()
        tr = lower_cell(cell, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_trace = time.time()
        s = tr.summary()
        rec["memory_analysis"] = _mem_dict(cell, tr)
        rec["cost_analysis"] = {"flops": s.flops,
                                "bytes accessed": s.hbm_bytes}
        rec["hlo"] = {
            "flops_per_device": s.flops,
            "flops_raw_unscaled": s.raw_flops,
            "bytes_read_per_device": s.bytes_read,
            "bytes_written_per_device": s.bytes_written,
            "collective_bytes_per_device": s.collective_bytes,
            "collective_count": s.collective_count,
        }
        rec["trace"] = _trace_dict(tr, s)
        rec["timing_s"] = {"lower": t_build - t0, "trace": t_trace - t_build,
                           "compile": 0.0}
        tr = None                            # free what the trace holds
        if dev.type == "cuda":
            rec["measured"] = measure(cell)
        rec["ok"] = True
        print(f"[dryrun] {arch} x {shape} x {mesh_name} ({dev.type}): OK "
              f"(build {rec['timing_s']['lower']:.1f}s, "
              f"trace {rec['timing_s']['trace']:.1f}s)")
        print("  memory_analysis:", rec["memory_analysis"])
        print("  hlo: flops/dev=%.3e coll=%s" % (
            s.flops, {k: f"{v:.2e}" for k, v in s.collective_bytes.items()}))
        if "measured" in rec:
            print("  measured: step %.4fs peak %.2f GB" % (
                rec["measured"]["step_s"],
                rec["measured"]["peak_memory_bytes"] / 1e9))
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape} x {mesh_name}: FAIL {rec['error']}")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{arch}__{shape}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def parse_overrides(items) -> dict:
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="explicit arch__shape cell names")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", nargs="*", default=[],
                    help="key=value model/spec overrides (hillclimb)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, mesh 'one'), meta (shapes only) "
                         "or cpu")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.override)
    if args.cells:
        todo = [tuple(c.split("__", 1)) for c in args.cells]
    elif args.all:
        todo, _ = applicable_cells(all_archs())
    else:
        assert args.arch and args.shape, "--arch/--shape, --cells or --all"
        todo = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = n_skip = 0
    for arch, shape in todo:
        for mesh_name in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        n_skip += 1
                        continue
            rec = run_cell(arch, shape, mesh_name, args.out,
                           overrides or None, device=args.device)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
