"""Stateless per-vertex randomness for correlated Poisson sampling (twin
of ``repro.core.rng``), plus a host-side threefry2x32 key schedule.

LABOR needs every seed that considers vertex ``t`` to see the same
uniform variate ``r_t`` (paper §3.2). It comes from a stateless 32-bit
hash of (salt, t); Neighbor Sampling's per-edge ``r_ts`` hashes
(salt, t, s). PyTorch has no usable uint32 arithmetic on the CPU,
so the hash runs on int64 tensors holding values in [0, 2^32): every
product is split into 16-bit halves so that no intermediate exceeds
2^49, and every result is masked back to 32 bits. Padding ids of -1
hash as 0xFFFFFFFF, exactly like the reference's uint32 cast.

The salts themselves are derived on the host from a threefry2x32 key,
bit for bit as ``jax.random`` derives them with
``jax_threefry_partitionable=True`` (``split`` and ``fold_in`` are both
one threefry block over the counter pair (0, i)). A key is a plain
``(k0, k1)`` tuple of Python ints. :func:`uniform` runs the same block
vectorised over int64 tensors, as ``jax.random.uniform`` does, for the
model's initial parameters.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

_U32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F

Key = Tuple[int, int]


# ---------------------------------------------------------------------------
# the per-vertex hash (device tensors)
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 ``h`` in [0, 2^32) and a constant
    ``m`` < 2^32, without relying on int64 wrap-around."""
    lo = h & 0xFFFF
    hi = h >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _U32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_uniform(salt: int, ids: torch.Tensor) -> torch.Tensor:
    """Deterministic uniform variates in [0, 1) indexed by integer id:
    float32 of the same shape as ``ids`` (negative ids allowed)."""
    k = int(salt) & _U32
    h = ids.to(torch.int64) & _U32
    h = _mix(h ^ ((k * _M3) & _U32))
    h = _mix((h + k) & _U32)
    # 24 high bits -> [0, 1) float32 (exactly representable)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform_edge(salt: int, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
    """Per-(src, dst) uniform variates in [0, 1) -- the per-edge r_ts of
    vanilla Neighbor Sampling; float32 of the shape of ``src``."""
    k = int(salt) & _U32
    s = src.to(torch.int64) & _U32
    d = dst.to(torch.int64) & _U32
    h = _mix(s ^ ((k * _M3) & _U32))
    h = _mix(h ^ _mul32(d, _M1) ^ k)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# host-side salts and the threefry2x32 key schedule
# ---------------------------------------------------------------------------

def _mix_int(h: int) -> int:
    h &= _U32
    h ^= h >> 16
    h = (h * _M1) & _U32
    h ^= h >> 13
    h = (h * _M2) & _U32
    return h ^ (h >> 16)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _U32


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """One threefry2x32 block (20 rounds) of the counter pair (x0, x1)."""
    ks = (k0 & _U32, k1 & _U32, (k0 ^ k1 ^ 0x1BD11BDA) & _U32)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _threefry_tensor(k: Key, x1: torch.Tensor):
    """:func:`threefry2x32` of the counter pairs (0, x1) for an int64
    tensor ``x1`` of counters below 2^32; returns (x0, x1) tensors."""
    ks = (k[0] & _U32, k[1] & _U32, (k[0] ^ k[1] ^ 0x1BD11BDA) & _U32)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def uniform(k: Key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` on the
    CPU, bit for bit: 32 random bits per element (the two threefry
    words of counter i xor-ed), 23 of them as the mantissa of a float
    in [1, 2), minus 1, scaled and shifted. XLA contracts the scale and
    shift into one fused multiply-add; here the product is formed
    exactly in float64 and the sum rounded once to float32."""
    n = 1
    for d in shape:
        n *= int(d)
    x0, x1 = _threefry_tensor(k, torch.arange(n, dtype=torch.int64))
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    vals = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, vals).reshape(tuple(shape))


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in the int32 range."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return (0, seed & _U32)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)``."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & _U32)


def key_data(k: Key) -> Tuple[int, int]:
    """``jax.random.key_data(k)`` as two uint32 Python ints."""
    return (k[0] & _U32, k[1] & _U32)


def salt_from_key(k: Key) -> int:
    """Fold a key down to a uint32 salt for :func:`hash_uniform`."""
    d0, d1 = key_data(k)
    return _mix_int(d0 ^ _mix_int(d1))


def layer_salts_from_key(k: Key, num_layers: int,
                         shared: bool = False) -> List[int]:
    """Per-layer uint32 salts; ``shared`` reuses one salt (§A.8)."""
    if shared:
        return [salt_from_key(k)] * num_layers
    return [salt_from_key(fold_in(k, layer)) for layer in range(num_layers)]


def layer_salts_from_uint32(salt: int, num_layers: int,
                            shared: bool = False) -> List[int]:
    """Per-layer salts from a raw uint32 salt, remixed per layer."""
    salt = int(salt) & _U32
    if shared:
        return [salt] * num_layers
    return [_mix_int((salt + ((0x9E3779B9 * (layer + 1)) & _U32)) & _U32)
            for layer in range(num_layers)]
