"""The (query, key) pairs an attention mask keeps, counted on the host.

The attention kernels' costs (``cost`` in each kernel module) count their
operations by these pairs: queries right-aligned with the keys, causal
and sliding-window masks, as the kernels mask them.
"""
from __future__ import annotations

from typing import Optional


def query_pairs(q0: int, nq: int, sk: int, *, causal: bool = True,
                window: Optional[int] = None) -> int:
    """(query, key) pairs the mask keeps for ``nq`` queries at positions
    q0 .. q0 + nq - 1 over keys [0, sk): key j is visible to the query at
    position p when j <= p (causal) and j > p - window (windowed).  The
    count per query is piecewise linear in p, so each piece is summed as
    an arithmetic series (no tensor op: a cost is counted on the host)."""
    def visible(p):
        hi = min(p, sk - 1) if causal else sk - 1
        lo = max(0, p - window + 1) if window is not None else 0
        return hi - lo + 1
    cuts = {0, sk} | ({window, sk + window - 1} if window is not None
                      else set())
    edges = sorted({q0, q0 + nq} | {c for c in cuts if q0 < c < q0 + nq})
    total = 0
    for a, b in zip(edges, edges[1:]):
        first, last = visible(a), visible(b - 1)
        if first > 0 and last > 0:
            total += (first + last) * (b - a) // 2
    return total


def visible_pairs(sq: int, sk: int, *, causal: bool = True,
                  window: Optional[int] = None) -> int:
    """The pairs of an Sq x Sk attention, queries right-aligned with the
    keys (query i at position i + Sk - Sq), as the kernel masks them."""
    return query_pairs(sk - sq, sq, sk, causal=causal, window=window)
