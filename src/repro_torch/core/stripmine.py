"""Strip-mining scheduler (paper §IV intro, §VI.A.a) — C7.

Port of ``repro/core/stripmine.py``.  A vector machine processes a logical
vector longer than VLMAX in VLEN-sized strips; the same pattern at
framework scale is chunked processing of a long axis with a carried state.
Tails are handled by padding + predication (C3), i.e. the RVV
``vl < VLMAX`` final strip.

The reference lowers the strip loop to one ``lax.scan``; here it is a
Python loop (PyTorch runs eagerly, there is no trace to keep small), and
``unroll`` is accepted for the same signature and has no effect.  Axis
handling follows the reference exactly, including its treatment of a
negative ``axis`` (the strip is handed to ``body`` with the strip axis
first).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F


def num_strips(n: int, vlmax: int) -> int:
    return -(-n // vlmax)


def pad_to_strips(x: torch.Tensor, vlmax: int, axis: int = 0):
    """Pad ``axis`` of ``x`` up to a multiple of ``vlmax``.

    Returns (padded, lengths) where lengths[s] (int32) is the active ``vl``
    of strip ``s`` (== vlmax except possibly the last strip).
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    strips = num_strips(n, vlmax)
    pad = strips * vlmax - n
    cfg = [0, 0] * (x.ndim - axis)
    cfg[-1] = pad                        # F.pad lists the last axis first
    padded = F.pad(x, cfg) if pad else x
    lengths = torch.clamp(
        n - torch.arange(strips, dtype=torch.int32, device=x.device) * vlmax,
        max=vlmax)
    return padded, lengths


def _stack(outs: list):
    """Stack per-strip outputs (None, a tensor, or a tuple of them) on a
    new leading axis, as ``lax.scan`` stacks its ``ys``."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_stack([o[i] for o in outs]) for i in range(len(first)))
    return torch.stack(outs)


def stripmine(body: Callable[[Any, torch.Tensor, torch.Tensor],
                             tuple[Any, Any]],
              init_carry: Any, x: torch.Tensor, *, vlmax: int, axis: int = 0,
              unroll: int = 1):
    """Run ``body(carry, strip, vl) -> (carry, out)`` over VLEN-sized strips.

    ``strip`` has ``vlmax`` elements along ``axis`` (tail zero-padded) and
    ``vl`` (0-d int32) is the active length (predication handle for the
    tail strip).  Returns (final_carry, stacked_outs).  ``unroll`` has no
    effect (see the module docstring).
    """
    del unroll
    padded, lengths = pad_to_strips(x, vlmax, axis)
    strips = lengths.shape[0]
    moved = torch.movedim(padded, axis, 0)
    strips_arr = moved.reshape(strips, vlmax, *moved.shape[1:])
    carry, outs = init_carry, []
    for s in range(strips):
        carry, out = body(carry, torch.movedim(strips_arr[s], 0,
                                               axis if axis >= 0 else 0),
                          lengths[s])
        outs.append(out)
    return carry, (_stack(outs) if outs else None)


def stripmined_map(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   x: torch.Tensor, *, vlmax: int, axis: int = 0,
                   unroll: int = 1) -> torch.Tensor:
    """Carry-less strip-mined elementwise/banded map; reassembles the axis.

    ``fn(strip, vl)`` must be shape-preserving along ``axis``.
    """
    n = x.shape[axis]

    def body(carry, strip, vl):
        return carry, fn(strip, vl)

    _, outs = stripmine(body, None, x, vlmax=vlmax, axis=axis, unroll=unroll)
    # outs: (strips, ...) with the vlmax axis at position axis+1 — restitch.
    outs = _restitch(outs, axis)
    return outs.narrow(axis, 0, n)


def _restitch(outs: torch.Tensor, axis: int) -> torch.Tensor:
    """Merge the leading strip axis back into ``axis``."""
    moved = torch.movedim(outs, axis + 1, 1)          # (strips, vlmax, ...)
    flat = moved.reshape(-1, *moved.shape[2:])        # (strips*vlmax, ...)
    return torch.movedim(flat, 0, axis)
