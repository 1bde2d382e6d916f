"""Threefry keys and draws, bit for bit as ``jax.random`` makes them.

The port's copy of the key arithmetic the reference's sampler takes from
``jax.random`` (``jax._src.prng`` / ``jax._src.random`` of jax 0.9.0, whose
``jax_threefry_partitionable`` is on): ``threefry2x32`` (20 rounds, the key
schedule and rotations of ``prng._threefry2x32_lowering``), ``fold_in``
(``prng.threefry_fold_in``: the hash of the 64-bit word ``(0, data)``),
``random_bits32`` (``_threefry_random_bits_partitionable``: the hash of the
flat index split into (hi, lo) words, ``out0 ^ out1``), ``uniform``
(``random._uniform`` for float32: the top 23 bits as a mantissa in
[1, 2), minus one, scaled) and ``gumbel`` (``random._gumbel``, mode
"low": ``-log(-log(uniform(tiny, 1)))``).

Every function takes a leading slot axis: a key is an int64 tensor
``(..., 2)`` holding two uint32 words, and the draws come out
``(..., *shape)``.  torch has no full uint32 arithmetic, so every word
lives in an int64 and is masked back to 32 bits after each add and shift.
Keys and bits are exact.  The two logarithms of ``gumbel`` are XLA's
CPU float32 ``log`` copied op for op (:func:`xla_log`), so a Gumbel equals
jax's bit for bit, on the CPU and on the card (but for a double rounding
in an emulated fused multiply-add, about once in 2^29).  XLA's ``log`` is
not correctly rounded (about one value in five is a float32 step off), so
a correctly rounded log would move draws on a near-tie.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
TINY_F32 = float(torch.finfo(torch.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the words (x1, x2) under the key (k1, k2), all int64
    tensors holding uint32 values (broadcast together).  Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a slot axis: ``key`` (..., 2), ``data``
    an int tensor broadcasting against ``key[..., 0]`` (taken mod 2^32, as
    jax converts it to uint32).  Returns the new keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & MASK32)
    return torch.stack([o1, o2], dim=-1)


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for each key of ``key``
    (..., 2): int64 tensor (..., *shape) of uint32 values.  The partitionable
    layout: word i is the hash of the flat index i as (hi, lo) words."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return (b1 ^ b2).reshape(lead + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key of ``key`` (..., 2): float32 (..., *shape), bit for bit."""
    bits = random_bits32(key, shape)
    mant = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # the bounds as float32 values and their difference rounded to float32,
    # as jax computes them; Python scalars (no host-to-device copy)
    lo, hi = (float(np.float32(t)) for t in (minval, maxval))
    scale = float(np.float32(hi) - np.float32(lo))
    return torch.clamp(floats * scale + lo, min=lo)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a x b + c rounded once, as a fused multiply-add rounds it:
    the product of two float32 values is exact in float64, so only the
    float64 sum's rounding can differ from one rounding (a double rounding,
    about once in 2^29)."""
    c = c.double() if isinstance(c, torch.Tensor) else c
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# the float32 log of XLA's CPU backend (jax 0.9.0): Cephes' logf, the
# polynomial's multiply-adds and the product into the exponent term fused;
# constants as XLA holds them
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU backend computes it, op for op, so the
    same on every device: x = 2^e m with m in [sqrt(1/2), sqrt(2)), a
    degree-8 polynomial in m - 1 evaluated in three interleaved Horner
    chains, the exponent added back in two parts (q2 e is exact).  Inputs
    below the smallest normal in magnitude read as zero (-inf; XLA flushes
    subnormals), other negatives give NaN, +inf gives +inf; log(1) = 0
    exactly."""
    x = x.float()
    bits = torch.clamp(x, min=TINY_F32).view(torch.int32)
    # m in [0.5, 1): the mantissa under the exponent of 0.5
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 126).float()
    low = m < _SQRTHF
    e = e - low.float()
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(fma32(t, p[0], p[1]), t, p[2])
    y1 = fma32(fma32(t, p[3], p[4]), t, p[5])
    y2 = fma32(fma32(t, p[6], p[7]), t, p[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, _LOG_Q1 * e)
    out = ((t - 0.5 * x2) + y) + _LOG_Q2 * e
    out = torch.where(x.abs() < TINY_F32, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x <= -TINY_F32) | torch.isnan(x), float("nan"), out)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") for each key
    of ``key`` (..., 2): float32 (..., *shape), bit for bit."""
    u = uniform(key, shape, TINY_F32, 1.0)
    return -xla_log(-xla_log(u))
