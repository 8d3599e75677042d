"""Flash attention (causal or not, GQA) over contiguous Q/K/V: the Hopper
kernel's wrapper and its plain PyTorch version.

Port of `repro.kernels.flash_attention` (TPU kernel
`flash_attention_pallas`, kernel.py:64).  q (b, sq, hq, d) attends over
k, v (b, skv, hkv, d); query head h reads kv head h // (hq // hkv)
without a repeated K/V.  `q_offset` places the queries at absolute
positions q_offset .. q_offset + sq - 1 (the chunked-prefill geometry);
keys at or past skv are masked, and with `causal` a query sees the keys
at or before its own position.

* `flash_attention` — the entry point.  A CUDA tensor launches the
  hand-written kernel (`kernels/csrc/flash_attention.cu`) or raises on a
  device, dtype, shape or layout it does not take; a CPU tensor takes
  the plain version.  There is no fallback between the two.  `launches`
  counts kernel launches.
* `flash_attention_plain` — one masked f32 softmax in batched torch.

Both compute scores in f32, keep l as the sum of the f32
probabilities, and round p to V's dtype before the PV product, as the
TPU kernel does (kernel.py:57): bf16 rounds p there, f32 is exact.  The
kernel takes any sq and skv (the TPU kernel asserts sq % block_q == 0
and pads K/V to its block).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B

NEG_INF = -1e30

# kernel launches since import (reset by callers that count a run)
launches = 0

# element-type codes of the C interface (csrc/flash_attention.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel geometry (csrc/flash_attention.cu Tiles / Layout): query rows,
# kv rows and shared-memory row padding per dtype
TILES = {torch.bfloat16: (64, 64, 8), torch.float32: (32, 32, 4)}
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d) in
    q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                         # (b,h,g,q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, hq, d).to(q.dtype)


# ----------------------------------------------------------- the kernel

def _round128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(dtype, d: int) -> int:
    """Dynamic shared memory of one block (flash_attention.cu Layout)."""
    bq, bkv, pad = TILES[dtype]
    e = torch.tensor([], dtype=dtype).element_size()
    ldq, lds, ldp, ldo = d + pad, bkv + 4, bkv + pad, d + 4
    return (_round128(e * bq * ldq) + 2 * _round128(e * bkv * ldq)
            + _round128(4 * bq * lds) + _round128(e * bq * ldp)
            + _round128(4 * bq * ldo) + 2 * _round128(4 * bq))


def _launch(q, k, v, causal: bool, q_offset: int):
    global launches
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v must have q's dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("want q (b, sq, hq, d) and k, v (b, skv, hkv, d)")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    if b * hq > 65535:
        raise ValueError(f"b * hq = {b * hq} exceeds the grid's 65535")
    if smem_bytes(q.dtype, d) > MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than a "
                         f"block has")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    lib = B.library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, d, int(q_offset), int(causal),
            DTYPE_CODES[q.dtype], stream)
    B.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, q_offset=0):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) in q's dtype ->
    (b, sq, hq, d) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, q_offset)
