"""Chaining (paper §VI.A.b — C5): the multiply chained into the reduction.

Port of ``chained_mulreduce`` from ``repro/core/chaining.py``.  In Ara the
SIMD multiplier and the adder are separate functional units, so a
``vfmul`` chains into a ``vfredsum``; the fused kernel form is
``kernels/dotp.py``.  The reference's ``grad_accum_chained`` belongs to the
training path and is not here.
"""
from __future__ import annotations

import torch


def chained_mulreduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """vfmul→vfredsum as one expression: the product is taken in the
    *input* dtype and only the sum in float32, as the reference's
    ``jnp.sum(a * b, dtype=float32)`` does (``ops.dotp``'s plain version
    widens before it multiplies; for bf16 the two differ)."""
    return (a * b).sum(dtype=torch.float32)
