"""fconv2d — valid 2-D convolution, NHWC x HWIO -> NHWC (paper §VI.A).

Port of ``repro/kernels/conv2d.py`` (``conv2d``, the Pallas kernel at :46).
Two versions of one function live here:

  * :func:`conv2d_plain` — the valid convolution in float32 as the TPU
    kernel shapes it, KH·KW shifted (pixels, Cin) x (Cin, Cout) products
    summed tap by tap, cast to ``x.dtype`` (the CPU path, and the oracle
    the CUDA kernel is held against; ``kernels/ref.py`` defines the same
    function with ``lax.conv_general_dilated``);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/conv2d.cu``):
    8 x 16 output pixels x 64 output channels per block, the input halo
    and the weights in shared memory, an f32 register accumulator; ragged
    output tiles masked in the kernel.

``ops.conv2d`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "conv2d"
SOURCE = "src/repro_torch/kernels/csrc/conv2d.cu"
REPLACES = "src/repro/kernels/conv2d.py:46"
TH, TW, CO = 8, 16, 64          # csrc/conv2d.cu's tile
SMEM_BUDGET = 96 * 1024         # bytes a block stages: two blocks per SM

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def _out_hw(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int]:
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d: x {tuple(x.shape)} (NHWC), w "
                         f"{tuple(w.shape)} (HWIO)")
    ho, wo = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d: window {tuple(w.shape[:2])} larger than "
                         f"the image {tuple(x.shape[1:3])}")
    return ho, wo


def conv2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), w (KH, KW, Cin, Cout) -> (N, Ho, Wo, Cout) in x's
    dtype, summed in float32."""
    ho, wo = _out_hw(x, w)
    kh, kw = w.shape[:2]
    xf, wf = x.float(), w.float()
    out = torch.zeros((x.shape[0], ho, wo, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for ky in range(kh):
        for kx in range(kw):
            out += xf[:, ky:ky + ho, kx:kx + wo, :] @ wf[ky, kx]
    return out.to(x.dtype)


def error_bound(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per output element, how far the kernel's float32 result may lie from
    :func:`conv2d_plain`'s before rounding to the output dtype:
    c 2^-24 sum |x w| over the window with c = KH KW Cin + KH KW + Cin —
    the kernel's one fmaf chain over the KH KW Cin terms, and the plain
    version's per-tap product over Cin (product rounding included) and
    its sum over the KH KW taps (first-order bounds, TF32 excluded)."""
    kh, kw, cin, _ = w.shape
    c = kh * kw * cin + kh * kw + cin
    return c * 2.0 ** -24 * conv2d_plain(x.float().abs(), w.float().abs())


def smem_floats(kh: int, kw: int, cc: int) -> int:
    """Shared-memory floats of one pass over ``cc`` input channels: the
    halo rounded up to whole float4s, then the weights (csrc/conv2d.cu)."""
    halo = (TH + kh - 1) * (TW + kw - 1) * cc
    return -(-halo // 4) * 4 + kh * kw * cc * CO


_ARGS = [_build.I, _build.P, _build.P, _build.P] + [_build.I] * 9 + [
    _build.P]


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CUDA kernel.  x (N, H, W, Cin), w (KH, KW, Cin, Cout), both float32
    or both bfloat16.  Returns (N, Ho, Wo, Cout) in x's dtype."""
    global launches
    _build.require_cuda(NAME, x, w)
    ho, wo = _out_hw(x, w)
    dt = _build.dtype_code(x, w)
    x, w = x.contiguous(), w.contiguous()
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    _build.int32_sizes(NAME, n, h, wd, cin, cout)
    cc = min(cin, SMEM_BUDGET // 4 // smem_floats(kh, kw, 1))
    if cc < 1:
        raise ValueError(f"conv2d: a {kh} x {kw} window does not fit the "
                         f"kernel's shared memory")
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if n == 0 or cout == 0:
        return y
    vec = int(cout % 8 == 0 and y.data_ptr() % 16 == 0)
    fn = _build.bind(NAME, "conv2d_launch", _ARGS)
    code = fn(dt, _build.ptr(x), _build.ptr(w), _build.ptr(y), n, h, wd,
              cin, kh, kw, cout, cc, vec, _build.stream_of(x))
    launches += 1
    _build.check(code, NAME)
    return y
