"""fmatmul — C = A @ B with a float32 accumulator, C in A's dtype.

Port of ``repro/kernels/matmul.py`` (``matmul``, the Pallas kernel at :51).
Two versions of one function live here:

  * :func:`matmul_plain` — ``kernels/ref.py``'s oracle in plain PyTorch:
    the float32 product of the widened operands, cast to ``a.dtype`` (the
    CPU path, and the oracle the CUDA kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/matmul.cu``):
    one in-order float32 accumulation over k per element (no split-K: the
    bits repeat), rounded to the output dtype once.  bfloat16: on the
    tensor cores, 128 x 256 tiles of C, a producer thread bringing 64-deep
    K tiles by TMA into a 4-stage ring, two consumer warpgroups running
    wgmma m64n256k16; TMA zero-fills ragged edges, and an operand whose
    base or row stride is not 16-byte aligned goes through
    :func:`pad_operands` first.  Bound: operations, 2 M N K at the 989
    TFLOP/s bf16 tensor-core peak (0.139 ms at 4096^3).  float32: on the
    CUDA cores (the paper's FPU), 128 x 128 tiles, 16-deep K tiles by
    cp.async into a 4-stage ring, two 256-thread blocks an SM, ragged M /
    N / K masked in the kernel.  Bound: 2 M N K at the 67 TFLOP/s float32
    CUDA-core peak (2.05 ms at 4096^3).

``ops.matmul`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "matmul"
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:51"
BK = 32          # K slice a planted fault drops (``chip_smoke.py``): two of
                 # the f32 kernel's 16-deep tiles, half of the bf16 kernel's
                 # 64-deep one

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N): float32 product of the widened operands, cast to
    ``a``'s dtype.  On the card this is cuBLAS in float32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def error_bound_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of C, how far the kernel's float32 result may lie from
    the exact product (float64 of the operands) before rounding to the
    output dtype: K 2^-24 sum_k |a_ik b_kj|.  Each term passes through at
    most K roundings: the kernel's in-order chain (float32: fmaf; bf16: the
    tensor cores' k16 steps, fewer) and any order of the plain version's K
    terms, K - 1 additions plus its product (first-order bounds, TF32
    excluded).  So the same share holds the plain version too; a bf16
    output adds one bf16 ulp for its final rounding."""
    k = a.shape[1]
    return k * 2.0 ** -24 * torch.matmul(a.float().abs(), b.float().abs())


#: the plain version's share of the same exact product (see above)
plain_bound_exact = error_bound_exact


def exact_limit(got: torch.Tensor, exact: torch.Tensor,
                share: torch.Tensor) -> torch.Tensor:
    """Per element, in float64, how far ``got`` may lie from the exact
    result ``exact``: ``share`` (a module's ``error_bound_exact`` or
    ``plain_bound_exact``), plus one bf16 ulp of the larger magnitude for
    a bf16 ``got`` (its final rounding).  dotp holds its results with the
    same limit."""
    lim = share.double()
    if got.dtype == torch.bfloat16:
        big = torch.maximum(got.double().abs(), exact.abs())
        _, e = torch.frexp(big)
        lim = lim + torch.where(big == 0, 0.0,
                                torch.ldexp(torch.ones_like(big), e - 8))
    return lim


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of C, how far the kernel's float32 result may lie from
    :func:`matmul_plain`'s before rounding to the output dtype: the two
    versions' shares of :func:`error_bound_exact` together, c 2^-24
    sum_k |a_ik b_kj| with c = 2 K."""
    return 2 * error_bound_exact(a, b)


def tma_ready(t: torch.Tensor) -> bool:
    """Can the bf16 kernel's TMA map read ``t`` (rows, cols) in place: at
    least one column, a 16-byte-aligned base, a unit last stride and a row
    stride of a multiple of 8 elements."""
    return (t.shape[1] > 0 and t.stride(1) == 1 and t.stride(0) % 8 == 0
            and t.data_ptr() % 16 == 0)


def pad_operands(a: torch.Tensor, b: torch.Tensor):
    """The bf16 kernel's padding step.  An operand its TMA map cannot read
    in place (:func:`tma_ready`) is copied into a zeroed buffer whose row
    stride is the next multiple of 8 elements, viewed at its own width; an
    empty K becomes one zero column (a TMA map has no empty axis).  Zero K
    columns add exact zeros, so the product is unchanged.  Returns (a, b,
    the names of the copied operands)."""
    k = max(a.shape[1], 1)
    out, copied = [], []
    for name, t, rows, cols in (("A", a, a.shape[0], k),
                                ("B", b, k, b.shape[1])):
        if tuple(t.shape) == (rows, cols) and tma_ready(t):
            out.append(t)
            continue
        buf = t.new_zeros((rows, -(-cols // 8) * 8))
        buf[:t.shape[0], :t.shape[1]] = t
        out.append(buf[:, :cols])
        copied.append(name)
    return out[0], out[1], tuple(copied)


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
    m, n = a.shape[0], b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if dt == 1:
        a, b, _ = pad_operands(a, b)
    k = a.shape[1]
    _build.int32_sizes(NAME, m, n, k)
    fn = _build.bind(NAME, "matmul_launch", _ARGS)
    code = fn(dt, _build.ptr(a), _build.ptr(b), _build.ptr(c), a.stride(0),
              b.stride(0), m, n, k, _build.stream_of(a))
    launches += 1
    _build.check(code, NAME)
    return c
