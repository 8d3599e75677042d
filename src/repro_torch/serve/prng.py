"""Threefry-2x32 counter-based random bits, bit-exact with `jax.random`.

The reference draws a sampled token with
`categorical(fold_in(key(seed), step), logits)` under partitionable
threefry (`repro/__init__.py` turns it on; it is the default on recent
jax).  This module reproduces that chain in torch, so a sampled row
draws the same token in both packages:

* `key(seed)` for a uint32 seed is the threefry key (0, seed);
* `fold_in(key, data)` is `threefry2x32(key, (0, data))`;
* `random_bits(key, n)`: draw i is `x0 ^ x1` of
  `threefry2x32(key, (hi(i), lo(i)))`, the 64-bit index i split into
  two 32-bit halves (the partitionable counter layout);
* `uniform` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1, and maps into [tiny, 1) as `jax.random.uniform` does;
* `gumbel` is `-log(-log(u))` over that uniform (mode "low", jax's
  default), and `categorical` the argmax of gumbel noise plus logits.

uint32 arithmetic is emulated on int64 tensors masked to 32 bits, so
every function runs vectorised on the tensors' device.  It is plain
tensor code, not a kernel.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# smallest normal float32 (jnp.finfo(float32).tiny)
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64
    tensors (broadcast together).  Returns the two output words."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(seed, data):
    """`fold_in(key(seed), data)` for (b,) uint32 seeds and data held in
    int64 tensors: the (b,) pair of key words."""
    return threefry2x32(torch.zeros_like(seed), seed & MASK32,
                        torch.zeros_like(data), data & MASK32)


def random_bits(k0, k1, n: int):
    """(b, n) 32-bit draws (as int64) of the keys (k0, k1), each (b,)."""
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], idx >> 32, idx & MASK32)
    return y0 ^ y1


def uniform(k0, k1, n: int):
    """(b, n) float32 draws in [tiny, 1), bit for bit
    `jax.random.uniform(key, (n,), minval=tiny, maxval=1)`."""
    bits = (random_bits(k0, k1, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(F32_TINY, dtype=torch.float32, device=k0.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=k0.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(k0, k1, n: int):
    """(b, n) float32 standard Gumbel noise (jax's mode "low")."""
    return -torch.log(-torch.log(uniform(k0, k1, n)))


def categorical(k0, k1, logits):
    """One draw per row of (b, V) float32 logits with keys (k0, k1):
    `jax.random.categorical`, as (b,) int64 indices."""
    return torch.argmax(gumbel(k0, k1, logits.shape[-1]) + logits, dim=-1)
