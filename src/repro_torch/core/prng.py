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
Keys and bits are exact.  The two logarithms of ``gumbel`` are taken in
float64 and rounded to float32, so a draw is the same on the CPU and on
the card (but for a double rounding, about once in 2^29); XLA's float32
``log`` differs from the correctly rounded one by an ulp now and then, so
a Gumbel may differ from jax's by a float32 step or two
(``tests/test_torch_sampling.py`` states the limit).
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


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 log through float64: the correctly rounded value (but for a
    double rounding), the same on every device."""
    return torch.log(x.double()).float()


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") for each key
    of ``key`` (..., 2): float32 (..., *shape), within a few ulps of jax's
    (its logarithms are rounded once each, see the module docstring)."""
    u = uniform(key, shape, TINY_F32, 1.0)
    return -_log32(-_log32(u))
