"""Hillclimb profiler: trace one cell and print its top collectives, top
traffic and top matmuls — the 'profile' of the dry-run methodology.

Port of `repro.launch.inspect`, over a trace of the port's step
(`launch/cells.py` `lower_cell`, `launch/trace.py`) in place of compiled
HLO.  The roofline terms are printed against a target of
`core/hwmodel.py`: the H100 (the port's card) by default, `--target
tpu-v5e` for the reference's constants.

    PYTHONPATH=src python -m repro_torch.launch.inspect --arch X --shape Y \\
        [--mesh single] [--override k=v ...] [--top 15] [--device meta]
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch.core.hwmodel import TARGETS
from repro_torch.distribution import collectives as C
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.dryrun import (MESHES, _check_device,
                                       apply_overrides, make_mesh_named,
                                       parse_overrides)
from repro_torch.configs import get_arch


def profile(arch: str, shape: str, mesh_name: str = "single",
            overrides: dict | None = None, top: int = 15, *,
            device="meta", target: str = "h100"):
    """Trace one call of the cell's step and print its top collectives
    (wire bytes by kind, result type and counter name), its top traffic
    (bytes read and written by op and result type; each kernel launch by
    the bytes it reports) and its top matmuls by FLOPs (by result type;
    each kernel by name).  Returns the trace's summary."""
    mesh = make_mesh_named(mesh_name)
    dev = _check_device(device, mesh)
    tgt = TARGETS[target]
    spec = apply_overrides(get_arch(arch), overrides)
    cell = build_cell(arch, shape, mesh, spec=spec, device=dev)
    C.STATS.reset()
    tr = lower_cell(cell, mesh)
    s = tr.summary()

    print(f"=== {arch} x {shape} x {mesh_name} "
          f"{'(overrides: %s)' % overrides if overrides else ''} ===")
    print(f"memory/dev: args {cell.meta['argument_bytes']/1e9:.2f} GB, "
          f"temp {tr.peak_live_bytes/1e9:.2f} GB")
    print(f"terms ({tgt.name}): compute {s.flops/tgt.peak_flops_bf16:.3f}s | "
          f"memory {(s.bytes_read+s.bytes_written)/tgt.hbm_bw_Bps:.3f}s | "
          f"collective {s.total_collective_bytes/tgt.ici_link_Bps:.3f}s")

    # ---- top collectives by (kind, shape, counter name)
    coll = defaultdict(lambda: [0.0, 0])
    for c in tr.collectives:
        key = (c.kind, c.result_type, c.name[:28])
        coll[key][0] += c.wire_bytes
        coll[key][1] += 1
    print("\n-- top collectives (wire bytes) --")
    for (kind, rtype, name), (b, n) in sorted(
            coll.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {b:12.3e} B  {kind:<20} {rtype:<36} x{n} in {name}")

    # ---- top traffic by (op, shape)
    traf = defaultdict(float)
    for op in tr.ops:
        if op.view or not (op.result_bytes or op.operand_bytes):
            continue
        traf[(op.name, op.result_type)] += op.result_bytes + op.operand_bytes
    for k in tr.kernels:
        traf[(f"kernel {k.name}", ", ".join(k.outputs))] += \
            k.bytes_read + k.bytes_written
    print("\n-- top traffic (result+operand bytes) --")
    for (opc, rtype), b in sorted(traf.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {b:12.3e} B  {opc:<30} {rtype}")

    # ---- top matmuls by flops
    dots = defaultdict(float)
    for op in tr.ops:
        if op.flops:
            dots[op.result_type] += op.flops
    for k in tr.kernels:
        dots[f"kernel {k.name}"] += k.flops
    print("\n-- top matmuls by flops --")
    for rtype, f in sorted(dots.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {f:12.3e} F  {rtype}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=sorted(MESHES))
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--override", nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, mesh 'one'), meta or cpu")
    ap.add_argument("--target", default="h100", choices=sorted(TARGETS))
    args = ap.parse_args(argv)
    profile(args.arch, args.shape, args.mesh,
            parse_overrides(args.override) or None, args.top,
            device=args.device, target=args.target)


if __name__ == "__main__":
    main()
