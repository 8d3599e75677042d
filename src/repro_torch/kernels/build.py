"""Build and load the port's CUDA kernels (one shared library, C ABI).

The sources under `kernels/csrc/` are compiled at first use with `nvcc`
for `sm_90a` — one `nvcc -c` per `.cu`, all started together, then one
link — into `build/repro_torch_kernels/` at the repository root, named
by a hash of the sources and flags, and loaded with `ctypes`.  Nothing
here runs at import time: CPU-only installs (no `nvcc`, no card) import
every module too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "paged_prefill.cu", "grouped_matmul.cu",
           "ssd_scan.cu")
HEADERS = ("paged_common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# repro_paged_decode(q, k, v, k_scale, v_scale, block_table, positions,
#   page_positions, out, m, l, b, hq, hkv, d, page, max_pages, q_dtype,
#   kv_dtype, partials, stream)
DECODE_ARGTYPES = [_VOIDP] * 11 + [_INT] * 9 + [_VOIDP]
# repro_paged_prefill(q, k, v, k_scale, v_scale, block_table, start,
#   chunk_len, page_positions, out, m, l, b, c, hq, hkv, d, page,
#   max_pages, rows_per_tile, q_dtype, kv_dtype, partials, stream)
PREFILL_ARGTYPES = [_VOIDP] * 12 + [_INT] * 11 + [_VOIDP]
# repro_grouped_matmul(x, w, out, rows, E, C, K, F, dtype, vec, stream)
GROUPED_ARGTYPES = [_VOIDP] * 4 + [_INT] * 6 + [_VOIDP]
# repro_ssd_intra_chunk(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, dtype,
#   stream)
SSD_ARGTYPES = [_VOIDP] * 8 + [_INT] * 6 + [_VOIDP]


def build_dir() -> Path:
    """`build/repro_torch_kernels/` at the repository root."""
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def source_digest() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((*ARCH_FLAGS, *CFLAGS)).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def build(out: Path) -> str:
    """Compile every source in parallel and link `out`.  Returns the
    compiler's messages (ptxas register and shared-memory reports);
    raises with nvcc's stderr when a step fails."""
    nvcc = _nvcc()
    work = out.parent / f".work-{out.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in SOURCES:
            obj = work / (Path(src).stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = []
        failed = []
        for src, _, p in procs:
            so, se = p.communicate()
            log.append(f"== {src}\n{so}{se}")
            if p.returncode != 0:
                failed.append(f"nvcc failed on {src} (exit {p.returncode}):\n"
                              f"{se}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, out)                 # atomic: readers see all or none
        return "\n".join(log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


class KernelLibrary:
    """The loaded shared library and how it came to be."""

    def __init__(self):
        out = build_dir() / f"libreprotorch_{source_digest()}.so"
        self.compiler_log = ""
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            self.compiler_log = build(out)
        self.path = out
        lib = ctypes.CDLL(str(out))
        lib.repro_paged_decode.argtypes = DECODE_ARGTYPES
        lib.repro_paged_decode.restype = ctypes.c_int
        lib.repro_paged_prefill.argtypes = PREFILL_ARGTYPES
        lib.repro_paged_prefill.restype = ctypes.c_int
        lib.repro_grouped_matmul.argtypes = GROUPED_ARGTYPES
        lib.repro_grouped_matmul.restype = ctypes.c_int
        lib.repro_ssd_intra_chunk.argtypes = SSD_ARGTYPES
        lib.repro_ssd_intra_chunk.restype = ctypes.c_int
        self.lib = lib


_library: KernelLibrary | None = None


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernels."""
    global _library
    if _library is None:
        _library = KernelLibrary()
    return _library


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
