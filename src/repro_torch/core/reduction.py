"""3-step hierarchical reductions (paper §V.e, Table II) — array level.

Port of the array-level half of ``repro/core/reduction.py``.  Ara
implements ``vredsum`` in three steps:

  1. **intra-lane**  — each lane reduces the elements it already holds
     (fully data-local; cost ~ VL_B / (8 ℓ) cycles),
  2. **inter-lane**  — log2(ℓ)+1 slide/ALU steps move partial results across
     lanes,
  3. **SIMD**        — the final 64-bit SIMD word is folded log2(8/EEW) times.

Ideal cycle model (paper): ``VL_B / (8 ℓ) + 1 + log2(ℓ)`` (the +1 is the
chained multiply for the dot-product benchmark).

``lane_tree_reduce`` performs the same elementwise operations in the same
order as the reference, so a float32 result equals it bit for bit.  Integer
inputs keep their dtype (int64 stays int64; the reference is int32 unless
``jax_enable_x64`` is set).  The mesh collectives of the reference
(``butterfly_allreduce``, ``hier_psum*``, ``lane_psum``) belong to the
multi-device work and are not here.
"""
from __future__ import annotations

import math

import torch

# Datapath width of one lane, bytes (paper: 64-bit lanes).
LANE_DATAPATH_BYTES = 8

_OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}


def simd_lanes(eew_bytes: int) -> int:
    """Elements per SIMD word in one lane cycle (8/EEW)."""
    return LANE_DATAPATH_BYTES // eew_bytes


def ideal_cycles(vl_bytes: int, lanes: int, *, chained_ops: int = 1) -> float:
    """Paper's ideal dot-product cycle count: VL_B/(8 ℓ) + chained + log2(ℓ)."""
    return (vl_bytes / (LANE_DATAPATH_BYTES * lanes) + chained_ops
            + math.log2(lanes))


def lane_tree_reduce(x: torch.Tensor, *, lanes: int, eew_bytes: int = 8,
                     op: str = "add") -> torch.Tensor:
    """Exact 3-step reduction of a 1-D vector distributed over ``lanes``.

    Element ``i`` belongs to lane ``i % lanes`` (VRF mapping, see
    ``core.vrf``).  Within a lane, elements are processed SIMD-words at a
    time (``8 // eew_bytes`` elements per cycle).  Returns a 0-d tensor
    equal to the full reduction, with the partial sums in the hardware's
    order (intra-lane slots first, then lane tree, then SIMD fold).
    """
    f = _OPS[op]
    n = x.shape[-1]
    k = simd_lanes(eew_bytes)
    if n % (lanes * k):
        raise ValueError(f"vector length {n} must divide lanes*simd="
                         f"{lanes * k}")
    v = x.reshape(-1, lanes, k)                     # [cycle, lane, simd_slot]

    # Step 1: intra-lane — reduce over the cycle axis (data-local).
    acc = v[0]
    for c in range(1, v.shape[0]):                  # sequential, as in HW
        acc = f(acc, v[c])                          # (lanes, k)

    # Step 2: inter-lane — log2(lanes) slide steps (recursive halving).
    stride = lanes // 2
    while stride >= 1:
        acc = f(acc[:stride], acc[stride:2 * stride])
        stride //= 2
    word = acc[0]                                   # (k,) one SIMD word

    # Step 3: SIMD fold — log2(k) steps within the word.
    stride = k // 2
    while stride >= 1:
        word = f(word[:stride], word[stride:2 * stride])
        stride //= 2
    return word[0]
