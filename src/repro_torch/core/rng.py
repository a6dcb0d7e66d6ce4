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
``(k0, k1)`` tuple of Python ints. :func:`uniform`, :func:`normal` and
:func:`randint` run the same block vectorised over int64 tensors, on the
CPU or the card, for the models' initial parameters and the LM prompts:
each bit for bit ``jax.random``'s draw (``normal`` through XLA's own CPU
``log1p`` and ``erf_inv``, evaluated operation for operation).
"""
from __future__ import annotations

import math
import struct
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


#: counters per pass of :func:`_random_bits`: bounds its int64
#: temporaries (16 M counters, 128 MB each) whatever the draw's size
_CHUNK = 1 << 24


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 2**32:
        raise ValueError(f"draw of {n} values: counters past 2^32 are not "
                         "implemented")
    return n


def _random_bits(k: Key, n: int, device):
    """``jax.random.bits(k, (n,), uint32)`` in passes of :data:`_CHUNK`
    counters: yields (start, int64 tensor of the pass's 32-bit words)."""
    for start in range(0, n, _CHUNK):
        ctr = torch.arange(start, min(n, start + _CHUNK), dtype=torch.int64,
                           device=device)
        x0, x1 = _threefry_tensor(k, ctr)
        yield start, x0 ^ x1


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c`` rounded once, as XLA's CPU
    code contracts a product into the add that uses it. The product of
    two floats is exact in float64; the float64 sum is made round-to-odd
    (its error, from a two-sum, sets the last bit), so rounding it to
    float32 rounds the exact value."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` on
    ``device``, bit for bit: 32 random bits per element (the two threefry
    words of counter i xor-ed), 23 of them as the mantissa of a float
    in [1, 2), minus 1, scaled and shifted by one fused multiply-add
    (:func:`fma`), as XLA's CPU code contracts them."""
    n = _numel(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    lo = _f32(minval, device)
    span = _f32(maxval, device) - lo
    for start, bits in _random_bits(k, n, device):
        out[start:start + bits.shape[0]] = _scaled(bits, span, lo)
    return out.reshape(tuple(shape))


def _scaled(bits: torch.Tensor, span: torch.Tensor,
            lo: torch.Tensor) -> torch.Tensor:
    """Random 32-bit words -> float32 uniforms in [lo, lo + span)."""
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    return torch.maximum(lo, fma(floats, span, lo))


def randint(k: Key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32), bit for
    bit: two split keys give higher and lower 32-bit words, and the
    offset is ``((hi % span) * m + lo % span) % span`` with ``m = (2^16 %
    span)^2 % span``, every product and sum in uint32 arithmetic that
    wraps as JAX's does (``m`` too: 0 for a span of 100,352)."""
    minval, maxval = int(minval), int(maxval)
    if not -2**31 <= minval < 2**31 or not -2**31 <= maxval < 2**31:
        raise ValueError("randint: bounds outside the int32 range")
    n = _numel(shape)
    span = (maxval - minval) & _U32 if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _U32) % span
    k1, k2 = split(k)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for (start, hi), (_, lo) in zip(_random_bits(k1, n, device),
                                    _random_bits(k2, n, device)):
        off = (_mul32(hi % span, mult) + lo % span) & _U32
        val = (off % span + minval) & _U32
        out[start:start + hi.shape[0]] = torch.where(
            val >= 2**31, val - 2**32, val).to(torch.int32)
    return out.reshape(tuple(shape))


def _hexf(bits: str) -> float:
    """A float32 constant written as the hex of its float64 value, as
    XLA's LLVM IR spells it."""
    return struct.unpack(">d", bytes.fromhex(bits))[0]


# XLA's CPU log and log1p (their LLVM IR, optimised): Cephes' logf
# polynomial on the argument split into mantissa and exponent; log1p takes
# a rational approximation x + (-x^2/2 + x^3 NUM(x)/DEN(x)) for
# |x| < sqrt(2) - 1 and the log of 1 + x elsewhere
_LOG1P_SMALL = _hexf("3FDA8279A0000000")
_LOG1P_DEN = tuple(map(_hexf, (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")))
_LOG1P_NUM = tuple(map(_hexf, (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")))
_LOGF_SQRTHF = _hexf("3FE6A09E60000000")
_LOGF_A = tuple(map(_hexf, (   # (t * A0 + A1) * t + A2, three chains
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")))
_LOGF_LN2_LO = _hexf("BF2BD01060000000")
_LOGF_LN2_HI = _hexf("3FE6300000000000")
_MIN_NORMAL = _hexf("3810000000000000")


def log(y: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU code computes it, bit for bit: Cephes'
    logf polynomial on y split into mantissa and exponent, the same
    operations in the same order, each rounded to float32, with the
    products that LLVM contracts into fused multiply-adds formed by
    :func:`fma`. ``torch.log`` is correctly rounded and differs from it
    in the last bit for about 1% of arguments."""
    dev = y.device

    def c(v):
        return _f32(v, dev)

    # y = m 2^e with m in [sqrt(1/2), sqrt(2))
    bits = torch.maximum(y, c(_MIN_NORMAL)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < c(_LOGF_SQRTHF)
    t = (m - 1.0) + torch.where(low, m, c(0.0))
    e = e - torch.where(low, c(1.0), c(0.0))
    z = t * t
    t3 = z * t
    a = _LOGF_A
    p0 = fma(fma(t, c(a[0]), c(a[1])), t, c(a[2]))
    p1 = fma(fma(t, c(a[3]), c(a[4])), t, c(a[5]))
    p2 = fma(fma(t, c(a[6]), c(a[7])), t, c(a[8]))
    r = fma(fma(fma(p0, t3, p1), t3, p2), t3, e * c(_LOGF_LN2_LO))
    out = fma(e, c(_LOGF_LN2_HI), fma(-z, c(0.5), t) + r)
    out = torch.where(y == math.inf, y, out)
    out = torch.where(y == 0, c(-math.inf), out)
    return torch.where(y < 0, c(math.nan), out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU code computes it, bit for bit
    (as :func:`log`): :func:`log` of 1 + x, and for |x| < sqrt(2) - 1 a
    rational approximation. ``torch.log1p`` differs from it in the last
    bit for about 8% of the arguments -u^2 that ``erf_inv`` feeds it."""
    dev = x.device

    def c(v):
        return _f32(v, dev)

    big = log(x + 1.0)
    # |x| small: x - x^2/2 + x^3 P(x)/Q(x)
    x2 = x * x
    num = c(_LOG1P_NUM[0]) + x * 0.0
    for q in _LOG1P_NUM[1:]:
        num = fma(num, x, c(q))
    den = c(1.0) + x * 0.0
    for q in _LOG1P_DEN:
        den = fma(den, x, c(q))
    small = x + fma(x2, c(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < c(_LOG1P_SMALL), small, big)


# M. Giles' single-precision erf^-1 coefficients ("Approximating the
# erfinv function", GPU Computing Gems), for w < 5 and for w >= 5
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 as XLA lowers ``lax.erf_inv`` on the CPU, bit for
    bit: Giles' polynomial in ``w = -log1p(-x^2)`` (:func:`log1p`, XLA's
    own), on ``w - 2.5`` or ``sqrt(w) - 3``, each step of the coefficient
    chain a fused multiply-add (:func:`fma`); ``+-inf`` at ``x = +-1``.
    The square root is taken in float64 and rounded, which is the exactly
    rounded float32 root (``torch.sqrt`` of a float32 CPU tensor is not,
    now and then). ``torch.erfinv`` is another approximation."""
    x = x.to(torch.float32)
    dev = x.device
    w = -log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0)

    def coef(i):   # float32 constants
        return torch.where(central, _f32(_ERFINV_CENTRAL[i], dev),
                           _f32(_ERFINV_TAIL[i], dev))

    p = coef(0)
    for i in range(1, len(_ERFINV_CENTRAL)):
        p = fma(p, w, coef(i))
    return x * torch.where(x.abs() == 1.0, _f32(math.inf, dev), p)


def normal(k: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32 on ``device``, bit for
    bit: ``sqrt(2) * erf_inv(u)`` with ``u = uniform(k, shape,
    nextafter(-1, 0), 1)``, one pass of :data:`_CHUNK` values at a
    time. On the ``meta`` device nothing is drawn: the result only has
    the shape and dtype (the dry run's parameter counts)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    n = _numel(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    lo = _f32(-1.0, device).nextafter(_f32(0.0, device))
    span = _f32(1.0, device) - lo
    sqrt2 = _f32(2.0 ** 0.5, device)
    for start, bits in _random_bits(k, n, device):
        out[start:start + bits.shape[0]] = sqrt2 * erf_inv(
            _scaled(bits, span, lo))
    return out.reshape(tuple(shape))


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
