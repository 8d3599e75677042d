"""Beyond-paper: the weight-stationary dataflow on a GPU's memory
hierarchy — the analytical HBM-traffic sweep (the kernels' traffic
model) plus a correctness-with-timing run of the two kernels on a small
shape, on the given device.

Port of `benchmarks/ws_dataflow.py`: the same rows and the same `ok`
rule (WS wins the decode regimes in the model), from the port's copy of
the model.  The kernel check runs `ws_matmul` and `os_matmul` on CUDA
unless `device` says otherwise (on the CPU the wrappers take the plain
version), holds `ws_matmul` to `matmul_plain` and `os_matmul` to
`ws_matmul`, and reports the check's time on its device as `check_ms`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.tolerance import worst_ratio
from repro_torch.kernels.ws_matmul import ops as ws_ops
from repro_torch.kernels.ws_matmul.ops import hbm_traffic_model, matmul_plain
from repro_torch.utils.device import resolve_device

# (m, k, n) regimes: decode (tiny m), prefill chunk, train matmul
SWEEP = [
    ("decode b=16", 16 * 8, 8192, 22016),
    ("decode b=128", 128 * 8, 8192, 22016),
    ("prefill chunk", 2048, 8192, 22016),
    ("train mlp", 16 * 4096, 2048, 8192),
]

# the check's tolerances: f32 against the plain version as the JAX
# reference benchmark holds it (rtol = atol = 1e-4); OS against WS as
# tests/test_kernels.py does (rtol 1e-5), with atol scaled by the row's
# largest |value| (kernels/tolerance.py's rule) so that an element near
# zero is held to its row's scale
CHECK_TOL = (1e-4, 1e-4)
TWIN_TOL = (1e-5, 1e-5)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device=None) -> dict:
    device = resolve_device(device)
    rows = []
    for name, m, k, n in SWEEP:
        pad = lambda x, b: -(-x // b) * b
        m2 = pad(m, 128)
        t_full_k = hbm_traffic_model(m2, n, k, bk=min(k, 2048))
        t_small_k = hbm_traffic_model(m2, n, k, bk=128)
        rows.append(dict(
            regime=name, m=m, k=k, n=n,
            ws_GB=t_full_k["weight_stationary"] / 1e9,
            os_GB=t_full_k["output_stationary"] / 1e9,
            ws_small_bk_GB=t_small_k["weight_stationary"] / 1e9,
            winner=("WS" if t_full_k["weight_stationary"]
                    <= t_full_k["output_stationary"] else "OS"),
        ))
    # decode regimes must favor weight-stationary (the paper's point)
    ok = all(r["winner"] == "WS" for r in rows if "decode" in r["regime"])

    # correctness-with-timing on a small shape, through the wrappers
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 256), np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal((256, 256), np.float32)).to(device)
    if device.type == "cuda":
        build.library()                   # built and loaded before the clock
    _sync(device)
    t0 = time.perf_counter()
    got = ws_ops.ws_matmul(x, w)
    _sync(device)
    t1 = time.perf_counter()
    twin = ws_ops.os_matmul(x, w)
    want = matmul_plain(x, w)
    check = worst_ratio(got, want, *CHECK_TOL)[1]
    twin_check = worst_ratio(twin, got, *TWIN_TOL)[1]
    ok &= check <= 1.0 and twin_check <= 1.0
    return {"name": "ws_dataflow", "ok": bool(ok), "rows": rows,
            "device": str(device), "check_ms": (t1 - t0) * 1e3,
            "check_err_over_bound": check, "twin_err_over_bound": twin_check}


def pretty(result: dict):
    print("== Weight-stationary vs output-stationary HBM traffic "
          "(the paper's dataflow, traffic model) ==")
    print(f"{'regime':<16}{'m':>8}{'k':>7}{'n':>7}{'WS GB':>9}{'OS GB':>9}"
          f"{'WS bk=128':>11}  winner")
    for r in result["rows"]:
        print(f"{r['regime']:<16}{r['m']:>8}{r['k']:>7}{r['n']:>7}"
              f"{r['ws_GB']:>9.2f}{r['os_GB']:>9.2f}"
              f"{r['ws_small_bk_GB']:>11.2f}  {r['winner']}")
    print(f"kernel check on {result['device']}: {result['check_ms']:.3f} ms "
          f"(err / bound {result['check_err_over_bound']:.3g}; OS vs WS "
          f"{result['twin_err_over_bound']:.3g})")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} "
          "(WS wins the paper's decode regime)\n")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    pretty(run(ap.parse_args().device))
