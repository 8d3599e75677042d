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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "paged_prefill.cu", "grouped_matmul.cu",
           "grouped_matmul_bwd.cu", "ssd_scan.cu", "ssd_scan_bwd.cu",
           "decode_attention.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "ws_matmul.cu")
HEADERS = ("paged_common.cuh", "mma_common.cuh", "paged_tc.cuh",
           "wgmma_common.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# repro_paged_decode(q, k, v, k_scale, v_scale, block_table, positions,
#   page_positions, out, m, l, part, tickets, b, hq, hkv, d, page,
#   max_pages, pages_per_split, q_dtype, kv_dtype, partials, stream)
DECODE_ARGTYPES = [_VOIDP] * 13 + [_INT] * 10 + [_VOIDP]
# repro_paged_prefill(q, k, v, k_scale, v_scale, block_table, start,
#   chunk_len, page_positions, out, m, l, b, c, hq, hkv, d, page,
#   max_pages, rows_per_tile, q_dtype, kv_dtype, partials, stream)
PREFILL_ARGTYPES = [_VOIDP] * 12 + [_INT] * 11 + [_VOIDP]
# repro_grouped_matmul(x, w, out, rows, E, C, K, F, dtype, vec, stream)
GROUPED_ARGTYPES = [_VOIDP] * 4 + [_INT] * 6 + [_VOIDP]
# repro_grouped_blocks_per_sm(vec, int* blocks)
GROUPED_BLOCKS_ARGTYPES = [_INT, ctypes.POINTER(_INT)]
# repro_grouped_matmul_bwd(x, w, dy, dy16, dx, dw, rows, E, C, K, F,
#   dtype, sms, passes, stream)
GROUPED_BWD_ARGTYPES = [_VOIDP] * 7 + [_INT] * 7 + [_VOIDP]
# repro_grouped_bwd_blocks_per_sm(kind, int* blocks)
GROUPED_BWD_BLOCKS_ARGTYPES = [_INT, ctypes.POINTER(_INT)]
# repro_ssd_intra_chunk(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, dtype,
#   stream)
SSD_ARGTYPES = [_VOIDP] * 8 + [_INT] * 6 + [_VOIDP]
# repro_ssd_intra_chunk_bwd(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt,
#   dseg_q, dseg_k, dww, dA, bh, nc, l, p, n, dtype, stream)
SSD_BWD_ARGTYPES = [_VOIDP] * 15 + [_INT] * 6 + [_VOIDP]
# repro_decode_attention(q, k, v, positions, out, m, l, acc, part, tickets,
#   b, hq, hkv, S, d, splits, split_len, partials, dtype, stream)
SPLIT_DECODE_ARGTYPES = [_VOIDP] * 10 + [_INT] * 9 + [_VOIDP]
# repro_combine_splits(m, l, acc, out, bh, group, d, splits, dtype, stream)
COMBINE_ARGTYPES = [_VOIDP] * 4 + [_INT] * 5 + [_VOIDP]
# repro_flash_attention(q, k, v, out, b, sq, skv, hq, hkv, d, q_offset,
#   causal, dtype, stream)
FLASH_ARGTYPES = [_VOIDP] * 4 + [_INT] * 9 + [_VOIDP]
# repro_flash_attention_lse(q, k, v, out, lse, b, sq, skv, hq, hkv, d,
#   q_offset, causal, dtype, stream)
FLASH_LSE_ARGTYPES = [_VOIDP] * 5 + [_INT] * 9 + [_VOIDP]
# repro_flash_attention_bwd(q, k, v, o, dout, lse, dsum, part, dq, dk, dv,
#   b, sq, skv, hq, hkv, d, q_offset, causal, splits, dtype, passes, stream)
FLASH_BWD_ARGTYPES = [_VOIDP] * 11 + [_INT] * 11 + [_VOIDP]
# repro_ws_matmul(x, w, out, M, N, K, bm, bn, bk, splits, dtype, vec,
#   stream)
WS_ARGTYPES = [_VOIDP] * 3 + [_INT] * 9 + [_VOIDP]
# repro_os_matmul(x, w, out, M, N, K, bm, bn, dtype, vec, stream)
OS_ARGTYPES = [_VOIDP] * 3 + [_INT] * 7 + [_VOIDP]
# repro_matmul_blocks_per_sm(os, dtype, bk, per, int* blocks)
BLOCKS_PER_SM_ARGTYPES = [_INT] * 4 + [ctypes.POINTER(_INT)]


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
        lib.repro_grouped_blocks_per_sm.argtypes = GROUPED_BLOCKS_ARGTYPES
        lib.repro_grouped_blocks_per_sm.restype = ctypes.c_int
        lib.repro_grouped_matmul_bwd.argtypes = GROUPED_BWD_ARGTYPES
        lib.repro_grouped_matmul_bwd.restype = ctypes.c_int
        lib.repro_grouped_bwd_blocks_per_sm.argtypes = \
            GROUPED_BWD_BLOCKS_ARGTYPES
        lib.repro_grouped_bwd_blocks_per_sm.restype = ctypes.c_int
        lib.repro_ssd_intra_chunk.argtypes = SSD_ARGTYPES
        lib.repro_ssd_intra_chunk.restype = ctypes.c_int
        lib.repro_ssd_intra_chunk_bwd.argtypes = SSD_BWD_ARGTYPES
        lib.repro_ssd_intra_chunk_bwd.restype = ctypes.c_int
        lib.repro_decode_attention.argtypes = SPLIT_DECODE_ARGTYPES
        lib.repro_decode_attention.restype = ctypes.c_int
        lib.repro_combine_splits.argtypes = COMBINE_ARGTYPES
        lib.repro_combine_splits.restype = ctypes.c_int
        lib.repro_flash_attention.argtypes = FLASH_ARGTYPES
        lib.repro_flash_attention.restype = ctypes.c_int
        lib.repro_flash_attention_lse.argtypes = FLASH_LSE_ARGTYPES
        lib.repro_flash_attention_lse.restype = ctypes.c_int
        lib.repro_flash_attention_bwd.argtypes = FLASH_BWD_ARGTYPES
        lib.repro_flash_attention_bwd.restype = ctypes.c_int
        lib.repro_ws_matmul.argtypes = WS_ARGTYPES
        lib.repro_ws_matmul.restype = ctypes.c_int
        lib.repro_os_matmul.argtypes = OS_ARGTYPES
        lib.repro_os_matmul.restype = ctypes.c_int
        lib.repro_matmul_blocks_per_sm.argtypes = BLOCKS_PER_SM_ARGTYPES
        lib.repro_matmul_blocks_per_sm.restype = ctypes.c_int
        self.lib = lib


_library: KernelLibrary | None = None
_library_lock = threading.Lock()


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernels.  Locked: the
    network front's engine thread and a caller's thread may both reach
    the first launch."""
    global _library
    with _library_lock:
        if _library is None:
            _library = KernelLibrary()
    return _library



def plain_device(t) -> bool:
    """Whether `t` takes a kernel's plain version: a CPU tensor, or a
    "meta" one (shapes only: no kernel runs on it, as when the dry-run
    traces a step, `launch/trace.py`).  A CUDA tensor launches the
    kernel or raises."""
    return t.device.type in ("cpu", "meta")

def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
