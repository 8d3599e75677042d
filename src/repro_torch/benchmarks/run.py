"""The port's paper harness — one module per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run               # on CUDA
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

Each module returns {"name", "ok", "rows"} and pretty-prints computed vs
published values; the harness exits nonzero if any paper claim fails.
Only `ws_dataflow` runs on a device (its kernel check); the analytic
tables need none.  Of the reference harness's serving benchmarks,
`traffic_gen` runs on its own (`python -m
repro_torch.benchmarks.traffic_gen`: it serves a model over the network
front); `serve_throughput` and `paged_kernel_bench` are not ported
yet.
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
)

MODULES = [table1_datapath, table23_diebench, table4_cost,
           table57_projection, resnet50_throughput, ws_dataflow]


def run_all(device=None) -> list[dict]:
    """Every module's result, `ws_dataflow`'s kernel check on `device`
    (CUDA unless told otherwise)."""
    return [mod.run(device) if mod is ws_dataflow else mod.run()
            for mod in MODULES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's paper harness")
    ap.add_argument("--device", default=None,
                    help="device of ws_dataflow's kernel check: cuda (the "
                         "default) or cpu")
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
