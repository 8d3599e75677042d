"""Where the bf16 grouped-matmul backward's time goes, by ablation.

    python3 src/repro_torch/benchmarks/grouped_bwd_ablation.py

Builds copies of `kernels/csrc/grouped_matmul_bwd.cu` with one part of
the bf16 dX and dW kernels taken out, each into its own library (nvcc,
sm_90a, all at once), and times the dX and the dW pass of each, launched
alone, beside the kernels as built, in turns, at chip_smoke's
`GROUPED_BWD_CASES` (qwen3-moe-30b-a3b's training microbatch, a routing
draw's live rows). The ablations compute wrong outputs on purpose; only
the kernels as built are held against the plain version. Prints one
JSON line per case and one with ptxas's report. Needs one CUDA card.

Ablations (each a text substitution in the copy; the script fails if a
substitution no longer matches the source):
* "no products": no wgmma issued (the ring, its barriers and the
  epilogue of zeros remain);
* "no loads": every copy zero-fills instead of reading (TMA boxes past
  the tensor's last expert, cp.async with source size 0; the products
  run on zeros and are stored);
* "no stores": no store of the output (its rounding and the transposes
  within quads of lanes remain);
* "skeleton": no loads and no stores.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "grouped_bwd_ablation"

_NO_PRODUCTS = [("      if (mine) {\n        fence_proxy_async();",
                 "      if (mine && n_items < 0) {\n        fence_proxy_async();")]
_NO_LOADS = [
    ("dy_map, f0, it.m0 + 64 * q, it.e, bar);",
     "dy_map, f0, it.m0 + 64 * q, it.e + 65536, bar);"),
    ("w_map, f0, it.n0 + 64 * q, it.e, bar);",
     "w_map, f0, it.n0 + 64 * q, it.e + 65536, bar);"),
    ("dy_map, it.n0 + 64 * q, c0, it.e, bar);",
     "dy_map, it.n0 + 64 * q, c0, it.e + 65536, bar);"),
    ("in ? xr + (long long)r * K + 8 * ch : x, in);", "x, false);")]
_NO_STORES = [("if (row < m_lim && it.n0 + col < n_lim)",
               "if (row < m_lim && it.n0 + col < n_lim && n_items < 0)")]
ABLATIONS = {"kernel": [], "no products": _NO_PRODUCTS, "no loads": _NO_LOADS,
             "no stores": _NO_STORES, "skeleton": _NO_LOADS + _NO_STORES}


def build_all() -> tuple[dict, dict]:
    """One library per ablation; returns ({name: CDLL}, {name: ptxas's
    report of the backward's kernels})."""
    from chip_smoke import grouped_bwd_ptxas
    from repro_torch.kernels import build as kb
    src = (CSRC / "grouped_matmul_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(ABLATIONS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"grouped_bwd_ablation: {name!r}: {old!r} is "
                                 f"not in grouped_matmul_bwd.cu")
            text = text.replace(old, new)
        cu = OUT / f"ablation{i}.cu"
        cu.write_text(text)
        cmd = [kb._nvcc(), *kb.ARCH_FLAGS, *kb.CFLAGS, "-shared", "-I",
               str(CSRC), "-o", str(OUT / f"libablation{i}.so"), str(cu)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    libs, ptxas = {}, {}
    for name, (i, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"grouped_bwd_ablation: {name!r} did not "
                             f"build:\n{err}")
        ptxas[name] = grouped_bwd_ptxas(err)
        lib = ctypes.CDLL(str(OUT / f"libablation{i}.so"))
        lib.repro_grouped_matmul_bwd.argtypes = kb.GROUPED_BWD_ARGTYPES
        lib.repro_grouped_matmul_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.tolerance import worst_ratio

    if not torch.cuda.is_available():
        raise SystemExit("grouped_bwd_ablation: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs, ptxas = build_all()
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(25)
    gdev = torch.Generator(device=dev).manual_seed(25)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev).zero_
    bf16 = torch.bfloat16
    E, k, C = 128, 8, cs.TRAIN_MOE_CAPACITY
    live = torch.clamp(cs.routed_rows(torch, E, cs.TRAIN_MOE_TOKENS, k, gen),
                       max=C).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K, F, label in cs.GROUPED_BWD_CASES:
        mask = (torch.arange(C, device=dev)[None, :]
                < live[:, None].long())[..., None]
        x = (torch.randn(E, C, K, generator=gdev, device=dev) * mask).to(bf16)
        w = (torch.randn(E, K, F, generator=gdev, device=dev) * 0.02).to(bf16)
        dy = torch.randn(E, C, F, generator=gdev, device=dev) * mask
        dy16 = torch.empty(E, C, F, dtype=bf16, device=dev)
        dx = torch.empty(E, C, K, dtype=bf16, device=dev)
        dw = torch.empty(E, K, F, dtype=bf16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, passes):
            err = lib.repro_grouped_matmul_bwd(
                x.data_ptr(), w.data_ptr(), dy.data_ptr(), dy16.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), live.data_ptr(), E, C, K, F,
                gm.DTYPE_CODES[bf16], sms, passes, stream)
            if err:
                raise SystemExit(f"grouped_bwd_ablation: CUDA error {err}")

        call(libs["kernel"], gm.BWD_ALL_PASSES)
        want = gm.grouped_matmul_backward_plain(x, w, dy, live)
        ratio = max(worst_ratio(g, w_, *gm.TOLERANCE[bf16],
                                floor=gm.bf16_rounding)[1]
                    for g, w_ in zip((dx, dw), want))
        if not ratio <= 1.0:
            raise SystemExit(f"grouped_bwd_ablation: the kernels as built "
                             f"disagree with the plain version ({ratio})")
        del want
        ms = {f"{name} {p}": [] for name in libs for p in ("dx", "dw")}
        for turn in range(2):
            order = list(libs) if turn == 0 else list(libs)[::-1]
            for name in order:
                for p in ("dx", "dw"):
                    ms[f"{name} {p}"].append(cs.time_ms(
                        lambda: call(libs[name], gm.BWD_PASSES[p]), flush,
                        iters=10, warmup=2))
        print(json.dumps({"case": label, "K": K, "F": F,
                          "live_rows": int(live.sum()),
                          "worst_err_over_bound": ratio, "ms": ms}),
              flush=True)
        del x, w, dy, dy16, dx, dw, mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
