"""fmatmul — C = A @ B with a float32 accumulator, C in A's dtype.

Port of ``repro/kernels/matmul.py`` (``matmul``, the Pallas kernel at :51).
Two versions of one function live here:

  * :func:`matmul_plain` — ``kernels/ref.py``'s oracle in plain PyTorch:
    the float32 product of the widened operands, cast to ``a.dtype`` (the
    CPU path, and the oracle the CUDA kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/matmul.cu``):
    128 x 128 output tiles, 32-deep K tiles in shared memory, an f32
    register accumulator; ragged M / N / K masked in the kernel.

``ops.matmul`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "matmul"
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:51"
BK = 32          # depth of the kernel's K tile (csrc/matmul.cu BK)

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N): float32 product of the widened operands, cast to
    ``a``'s dtype.  On the card this is cuBLAS in float32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of C, how far the kernel's float32 result may lie from
    :func:`matmul_plain`'s before rounding to the output dtype:
    c 2^-24 sum_k |a_ik b_kj| with c = 2 K.  The kernel's fmaf chain
    rounds each term at most K times; any order of the plain version's K
    terms rounds each at most K - 1 times, plus once for its product
    (first-order bounds, TF32 excluded)."""
    c = 2 * a.shape[1]
    return c * 2.0 ** -24 * torch.matmul(a.float().abs(), b.float().abs())


_ARGS = [_build.I, _build.P, _build.P, _build.P, _build.LL, _build.LL,
         _build.I, _build.I, _build.I, _build.P]


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CUDA kernel.  a (M, K), b (K, N), both float32 or both bfloat16, any
    row stride with a unit last stride.  Returns C (M, N) in a's dtype."""
    global launches
    _build.require_cuda(NAME, a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    dt = _build.dtype_code(a, b)
    a, b = _build.inner_contiguous(a), _build.inner_contiguous(b)
    m, k = a.shape
    n = b.shape[1]
    _build.int32_sizes(NAME, m, n, k)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    fn = _build.bind(NAME, "matmul_launch", _ARGS)
    code = fn(dt, _build.ptr(a), _build.ptr(b), _build.ptr(c), a.stride(0),
              b.stride(0), m, n, k, _build.stream_of(a))
    launches += 1
    _build.check(code, NAME)
    return c
