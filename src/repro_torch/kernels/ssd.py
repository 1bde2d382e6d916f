"""Mamba2 SSD chunked scan (state-space duality).

Port of ``repro/kernels/ssd.py`` (``ssd``, the Pallas kernel at :78).  Two
versions of one function live here:

  * :func:`ssd_plain` — the reference's ``ops._chunked_ssd_ref``
    (ops.py:511) in plain PyTorch: a loop over ``chunk``-token chunks with
    the dense intra-chunk products and the carried state (the CPU path and
    the oracle the CUDA kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/ssd.cu``): one
    block per (batch * head) row walking 64-token inner chunks with the
    state resident in shared memory; a ragged S is masked inside the
    kernel, and B/C rows shared by several heads are read in place.

``ops.ssd`` picks between them by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import NEG_INF, _pad_to

NAME = "ssd"
SOURCE = "src/repro_torch/kernels/csrc/ssd.cu"
REPLACES = "src/repro/kernels/ssd.py:78"
MAX_STATE = 128      # d_state the kernel holds (csrc/ssd.cu NM)
MAX_HEADDIM = 64     # headdim the kernel holds (csrc/ssd.cu PM)

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def ssd_plain(x, log_a, B, C, *, chunk: int, initial_state=None):
    """x: (BH, S, P); log_a: (BH, S); B/C: (BH, S, N); initial_state:
    (BH, N, P) or None (zeros).  Returns (y (BH, S, P) in x's dtype, final
    state (BH, N, P) f32).  A ragged tail is zero-padded to a whole chunk:
    log_a = 0 and x = 0 there give decay 1 and no input."""
    bh, s, p = x.shape
    n = B.shape[-1]
    dev = x.device
    state = (torch.zeros((bh, n, p), dtype=torch.float32, device=dev)
             if initial_state is None else initial_state.float())
    if s == 0:
        return x.clone(), state
    chunk = min(chunk, s)
    xp, lap, Bp, Cp = (_pad_to(t, chunk, 1) for t in (x, log_a, B, C))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    ys = []
    for c0 in range(0, xp.shape[1], chunk):
        xb = xp[:, c0:c0 + chunk].float()
        lab = lap[:, c0:c0 + chunk].float()
        Bb = Bp[:, c0:c0 + chunk].float()
        Cb = Cp[:, c0:c0 + chunk].float()
        cum = torch.cumsum(lab, dim=-1)                       # (BH, Q)
        total = cum[:, -1]
        seg = torch.where(tri, cum[:, :, None] - cum[:, None, :], NEG_INF)
        scores = torch.einsum("bin,bjn->bij", Cb, Bb) * torch.exp(seg)
        y = torch.einsum("bij,bjp->bip", scores, xb)
        y = y + torch.einsum("bin,bnp->bip",
                             Cb * torch.exp(cum)[..., None], state)
        w = torch.exp(total[:, None] - cum)[..., None] * Bb   # (BH, Q, N)
        state = (torch.exp(total)[:, None, None] * state
                 + torch.einsum("bjn,bjp->bnp", w, xb))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


_ARGS = ([_build.I] + [_build.P] * 7 + [_build.LL] * 10 + [_build.I] * 5
         + [_build.P])


def launch(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None):
    """CUDA kernel.  x: (BH, S, P); log_a: (BH, S); B/C: (BH / r, S, N),
    row g shared by x rows g * r .. g * r + r - 1; any strides with a unit
    last axis.  x/B/C float32 or bfloat16 (one type); log_a and
    initial_state are taken in f32.  Returns (y (BH, S, P) in x's dtype,
    final state (BH, N, P) f32)."""
    global launches
    _build.require_cuda(NAME, x, log_a, B, C, initial_state)
    bh, s, p = x.shape
    nb, _, n = B.shape
    if C.shape != B.shape or log_a.shape != (bh, s) or B.shape[1] != s:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if nb < 1 or bh % nb:
        raise ValueError(f"ssd: {nb} B/C rows do not divide {bh} x rows")
    if n > MAX_STATE or p > MAX_HEADDIM:
        raise ValueError(f"ssd: d_state {n} / headdim {p} above the "
                         f"kernel's {MAX_STATE} / {MAX_HEADDIM}")
    dt = _build.dtype_code(x, B, C)
    x, B, C = (_build.inner_contiguous(t) for t in (x, B, C))
    log_a = log_a.float()
    st0 = None
    if initial_state is not None:
        if initial_state.shape != (bh, n, p):
            raise ValueError(f"ssd: initial_state {tuple(initial_state.shape)}"
                             f", expected {(bh, n, p)}")
        st0 = initial_state.float().contiguous()
    y = torch.empty((bh, s, p), dtype=x.dtype, device=x.device)
    st = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    if bh == 0:
        return y, st
    fn = _build.bind(NAME, "ssd_launch", _ARGS)
    code = fn(dt, _build.ptr(x), _build.ptr(log_a), _build.ptr(B),
              _build.ptr(C), _build.ptr(st0), _build.ptr(y), _build.ptr(st),
              x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1),
              y.stride(0), y.stride(1), bh, s, n, p, bh // nb,
              _build.stream_of(x))
    launches += 1
    _build.check(code, NAME)
    return y, st
