"""Chained vfmul→vfredsum dot product (paper §V.e + §VI.A.b — C4 + C5).

Port of ``repro/kernels/dotp.py`` (``dotp``, the Pallas kernel at :56).
Two versions of one function live here:

  * :func:`dotp_plain` — ``kernels/ref.py``'s oracle in plain PyTorch:
    widen to float32, multiply, sum (the CPU path, and the oracle the CUDA
    kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/dotp.cu``): n
    split into G contiguous ranges (:func:`split`, a function of n alone),
    one block per range writes a partial, a second pass folds the partials
    in a fixed order, so the same input gives the same bits on every run.

The kernel does not reproduce the reference's (8, 128) slot order; its own
order is stated in ``csrc/dotp.cu`` and bounds its error by
:func:`depth` roundings per term.  ``ops.dotp`` picks between the two by
the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "dotp"
SOURCE = "src/repro_torch/kernels/csrc/dotp.cu"
REPLACES = "src/repro/kernels/dotp.py:56"
THREADS = 256        # threads per block (csrc/dotp.cu NT)
MAX_BLOCKS = 1024    # the most partials
GRAIN = 2048         # a range is a multiple of this many elements

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def split(n: int) -> tuple[int, int]:
    """(L, G): G ranges of L elements cover n (the last one ragged)."""
    per = -(-n // MAX_BLOCKS)
    length = max(GRAIN, -(-per // GRAIN) * GRAIN)
    return length, -(-n // length)


def depth(n: int) -> int:
    """Roundings any one term passes through in the kernel's order: its
    thread's chain (L / 256), two 8-level butterflies (pass 1 and pass 2)
    and the fold thread's chain over the partials."""
    length, g = split(n)
    return length // THREADS + 8 + -(-g // THREADS) + 8


def dotp_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n,) . (n,) -> 0-d float32: widen, multiply, sum."""
    return (a.float() * b.float()).sum()


def error_bound_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How far the kernel's result may lie from the exact dot product
    (float64 of the operands): depth(n) 2^-24 sum_i |a_i b_i| — each term
    passes through :func:`depth` roundings in the kernel's order, its
    product none (fmaf; first-order bound)."""
    return depth(a.shape[0]) * 2.0 ** -24 * _abs_sum(a, b)


def plain_bound_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same for :func:`dotp_plain`: (depth(n) + 1) 2^-24 sum_i |a_i
    b_i| — its product rounding, and its reduction (torch's sum, which
    spreads one sum over more threads than the kernel's 256 per range)
    taken as no deeper than the kernel's.  ``chip_smoke.py`` holds it to
    the float64 result at card shapes, so the assumption is checked, not
    taken on trust."""
    return (depth(a.shape[0]) + 1) * 2.0 ** -24 * _abs_sum(a, b)


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How far the kernel's result may lie from :func:`dotp_plain`'s: the
    two shares of the exact result together, c 2^-24 sum_i |a_i b_i| with
    c = 2 depth(n) + 1."""
    c = 2 * depth(a.shape[0]) + 1
    return c * 2.0 ** -24 * _abs_sum(a, b)


def _abs_sum(a, b):
    return dotp_plain(a.float().abs(), b.float().abs())


_ARGS = [_build.I, _build.P, _build.P, _build.P, _build.P, _build.LL,
         _build.LL, _build.I, _build.I, _build.P]


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CUDA kernel.  a, b: (n,), both float32 or both bfloat16.  Returns
    the 0-d float32 dot product."""
    global launches
    _build.require_cuda(NAME, a, b)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"dotp: shapes {tuple(a.shape)} . "
                         f"{tuple(b.shape)}")
    dt = _build.dtype_code(a, b)
    a, b = _build.inner_contiguous(a), _build.inner_contiguous(b)
    n = a.shape[0]
    length, g = split(n)
    part = torch.empty((g,), dtype=torch.float32, device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    vec = int(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    fn = _build.bind(NAME, "dotp_launch", _ARGS)
    code = fn(dt, _build.ptr(a), _build.ptr(b), _build.ptr(part),
              _build.ptr(out), n, length, g, vec, _build.stream_of(a))
    launches += 1
    _build.check(code, NAME)
    return out
