"""The dry-run and roofline tables of the PyTorch port's records.

The twin of `scripts/fill_experiments.py` over the port's dry-run
records (`python -m repro_torch.launch.dryrun ...`, one JSON per cell):
the same two tables, built by `repro_torch.launch.roofline`, with the
port's own columns beside them (the trace's seconds in place of the
compile's, and on card records the measured step and its MFU).  It
reads the directory it is given and prints the tables, or writes them
to the path named by --out; it writes no other file.

    PYTHONPATH=src python scripts/fill_experiments_torch.py \\
        [--dryrun-dir experiments/dryrun_torch] [--mesh single] \\
        [--target h100] [--out TABLES.md]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.hwmodel import TARGETS  # noqa: E402
from repro_torch.launch.roofline import (advice, fmt_s, load_rows,  # noqa: E402
                                         markdown_table)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DRYRUN = os.path.join(ROOT, "experiments", "dryrun_torch")


def dryrun_table(dirname=DRYRUN) -> str:
    out = ["| arch | shape | mesh | device | args GB/dev | temp GB/dev | "
           "flops/dev | collective B/dev | trace s | measured step |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(dirname)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(dirname, name)) as f:
            r = json.load(f)
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r.get('device', '')} | "
                       f"FAIL: {r.get('error', '')[:60]} | | | | | |")
            continue
        ma = r["memory_analysis"]
        h = r["hlo"]
        coll = sum(h["collective_bytes_per_device"].values())
        step = r.get("measured", {}).get("step_s")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('device', '')} | "
            f"{(ma.get('argument_size_in_bytes') or 0) / 1e9:.2f} | "
            f"{(ma.get('temp_size_in_bytes') or 0) / 1e9:.2f} | "
            f"{h['flops_per_device']:.2e} | {coll:.2e} | "
            f"{r['timing_s'].get('trace', 0.0):.1f} | "
            f"{fmt_s(step) if step else ''} |")
    return "\n".join(out)


def roofline_block(dirname=DRYRUN, mesh="single", target=None,
                   notes=True) -> str:
    rows = load_rows(dirname, mesh, target)
    lines = [markdown_table(rows)]
    if notes:
        lines += ["", "Per-cell bottleneck notes:", ""]
        for r in rows:
            if r.ok:
                lines.append(f"- **{r.arch} × {r.shape}** ({r.dominant}-bound, "
                             f"step≈{fmt_s(r.step_s)}): {advice(r)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=DRYRUN)
    ap.add_argument("--mesh", default="single",
                    help="the roofline table's mesh (single, multi, one)")
    ap.add_argument("--target", default=None, choices=sorted(TARGETS),
                    help="roofline constants (default: each record's own)")
    ap.add_argument("--out", default=None,
                    help="write the tables here instead of printing them")
    args = ap.parse_args(argv)
    text = "\n\n".join([
        "## Dry-run records", dryrun_table(args.dryrun_dir),
        f"## Roofline ({args.mesh})",
        roofline_block(args.dryrun_dir, args.mesh, args.target)])
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
