"""Where the bf16 SSD intra-chunk kernel's time goes, by ablation.

    python3 src/repro_torch/benchmarks/ssd_ablation.py

Builds copies of `kernels/csrc/ssd_scan.cu` with one part of the bf16
tensor-core kernel taken out, each into its own library (nvcc, sm_90a,
all at once), and times each beside the kernel as built, in turns, at
chip_smoke's timed SSD shapes (zamba2-2.7b l 64 and 256, mamba2-130m two
chunks of 256, and its ragged 200). The ablations compute wrong
outputs on purpose; only the kernel as built is held against the plain
version. Prints one JSON line per shape and one with ptxas's report.
Needs one CUDA card.

Ablations (each a text substitution in the copy; the script fails if a
substitution no longer matches the source):
* "no products": the y and state products skipped (copies, scan,
  barriers and the stores of zeros remain);
* "no loads": every copy zero-fills instead of reading (the products
  run on zeros and are stored);
* "no stores": no output stored (the compiler then drops the products:
  the copies, the scan and the barriers remain);
* "skeleton": no loads and no stores (the scan, the barriers and the
  zero-filling copies).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_ablation"

_NO_PRODUCTS = [
    ("if (warp_live && t0 <= warp_last) {",
     "if (warp_live && t0 <= warp_last && p < 0) {"),
    ("      if (warp_live) {\n        // s += B^T",
     "      if (warp_live && p < 0) {\n        // s += B^T")]
_NO_LOADS = [
    ("Bb + (live ? (long long)(t0 + tt) * n + e : 0), live);", "Bb, false);"),
    ("xb + (live ? (long long)(t0 + tt) * p + e : 0), live);", "xb, false);"),
    ("Cb + (live ? (long long)(r0 + r) * n + e : 0), live);", "Cb, false);")]
_NO_STORES = [("if (r >= rows) continue;", "if (r >= rows || p > 0) continue;")]
ABLATIONS = {"kernel": [], "no products": _NO_PRODUCTS, "no loads": _NO_LOADS,
             "no stores": _NO_STORES, "skeleton": _NO_LOADS + _NO_STORES}
SHAPES = ((640, 1, 64, 64, 64), (640, 1, 256, 64, 64), (24, 2, 256, 64, 128),
          (24, 1, 200, 64, 128))


def build_all() -> tuple[dict, dict]:
    """One library per ablation; returns ({name: CDLL}, {name: ptxas's
    report of each head-dim instance})."""
    from chip_smoke import ssd_ptxas
    from repro_torch.kernels import build as kb
    src = (CSRC / "ssd_scan.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(ABLATIONS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"ssd_ablation: {name!r}: {old!r} is not in "
                                 f"ssd_scan.cu")
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
            raise SystemExit(f"ssd_ablation: {name!r} did not build:\n{err}")
        ptxas[name] = ssd_ptxas(err)
        lib = ctypes.CDLL(str(OUT / f"libablation{i}.so"))
        lib.repro_ssd_intra_chunk.argtypes = kb.SSD_ARGTYPES
        lib.repro_ssd_intra_chunk.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tolerance import worst_ratio

    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablation: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs, ptxas = build_all()
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev).zero_
    bf16 = torch.bfloat16
    for bh, nc, l, p, n in SHAPES:
        x = torch.randn(bh, nc, l, p, generator=gen, device=dev).to(bf16)
        B = (torch.randn(bh, nc, l, n, generator=gen, device=dev) * 0.3).to(bf16)
        C = (torch.randn(bh, nc, l, n, generator=gen, device=dev) * 0.3).to(bf16)
        dt = torch.rand(bh, nc, l, generator=gen, device=dev) * 0.1
        A = -torch.linspace(1.0, 16.0, bh, device=dev)
        out = (torch.empty(bh, nc, l, p, device=dev),
               torch.empty(bh, nc, n, p, device=dev),
               torch.empty(bh, nc, device=dev))
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            err = lib.repro_ssd_intra_chunk(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), *(t.data_ptr() for t in out), bh, nc, l, p, n,
                ssd.DTYPE_CODES[bf16], stream)
            if err:
                raise SystemExit(f"ssd_ablation: CUDA error {err}")

        call(libs["kernel"])
        want = ssd.ssd_intra_chunk_plain(x, dt, A, B, C)
        ratio = max(worst_ratio(g, w, *ssd.TOLERANCE[bf16])[1]
                    for g, w in zip(out, want))
        if not ratio <= 1.0:
            raise SystemExit(f"ssd_ablation: the kernel as built disagrees "
                             f"with its plain version ({ratio})")
        ms = {name: [] for name in libs}
        for turn in range(2):
            order = list(libs) if turn == 0 else list(libs)[::-1]
            for name in order:
                ms[name].append(cs.time_ms(lambda: call(libs[name]), flush))
        print(json.dumps({"shape": {"bh": bh, "nc": nc, "l": l, "p": p,
                                    "n": n},
                          "blocks": ssd.num_blocks(bf16, bh, nc, l, n),
                          "worst_err_over_bound": ratio, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
