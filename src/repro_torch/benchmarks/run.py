"""The port's paper harness — one module per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run               # on CUDA
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

Each module returns {"name", "ok", "rows"} and pretty-prints computed vs
published values; the harness exits nonzero if any paper claim fails.
The analytic tables need no device; `ws_dataflow` (its kernel check),
and the reference harness's serving benchmarks `serve_throughput` (the
contiguous vs paged layouts), `paged_kernel_bench` (the paged kernels
against their plain versions) and `traffic_gen` (a two-tenant trace
over the network front) run on `--device`.  Nothing is written to the
working directory.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks import (
    table1_datapath,
    table23_diebench,
    table4_cost,
    table57_projection,
    resnet50_throughput,
    ws_dataflow,
    serve_throughput,
    paged_kernel_bench,
    traffic_gen,
)

# the paper's tables and its dataflow sweep, then the serving tools
PAPER_MODULES = [table1_datapath, table23_diebench, table4_cost,
                 table57_projection, resnet50_throughput, ws_dataflow]
MODULES = PAPER_MODULES + [serve_throughput, paged_kernel_bench, traffic_gen]
ON_DEVICE = (ws_dataflow, serve_throughput, paged_kernel_bench)


def run_all(device=None, modules=MODULES) -> list[dict]:
    """Every module's result (of `modules`), the device-bound ones on
    `device` (CUDA unless told otherwise); `traffic_gen` writes no JSON
    file."""
    out = []
    for mod in modules:
        if mod is traffic_gen:
            out.append(mod.run(json_path=None, device=device))
        elif mod in ON_DEVICE:
            out.append(mod.run(device=device))
        else:
            out.append(mod.run())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's paper harness")
    ap.add_argument("--device", default=None,
                    help="device of the kernel check and the serving "
                         "benchmarks: cuda (the default) or cpu")
    results = run_all(ap.parse_args(argv).device)
    for mod, res in zip(MODULES, results):
        mod.pretty(res)
    print("== summary ==")
    for res in results:
        print(f"  {res['name']:<24} {'PASS' if res['ok'] else 'FAIL'}")
    all_ok = all(res["ok"] for res in results)
    print(f"\n{'ALL PAPER CLAIMS REPRODUCED' if all_ok else 'FAILURES PRESENT'}"
          " (details above)")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
