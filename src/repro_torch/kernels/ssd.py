"""Mamba2 SSD chunked scan (state-space duality).

Port of ``repro/kernels/ssd.py`` (``ssd``, the Pallas kernel at :78).  Two
versions of one function live here:

  * :func:`ssd_plain` — the reference's ``ops._chunked_ssd_ref``
    (ops.py:511) in plain PyTorch: a loop over ``chunk``-token chunks with
    the dense intra-chunk products and the carried state (the CPU path and
    the oracle the CUDA kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/ssd.cu``),
    64-token chunks, a ragged S masked inside the kernel, B/C rows shared
    by several heads read in place.  bf16 runs on the tensor cores
    (mma.sync m16n8k16): each row's chunks are cut into :func:`pieces`, so
    a batch-1 prefill fills every SM; pass 1 writes each piece's local f32
    state, pass 2 folds the pieces before its own into its carry-in and
    scans its chunks from there.  The f32 operands of three of the four
    products (decayed scores, state, decay-weighted x) are fed as two bf16
    terms each.  f32 runs on the CUDA cores, one block per row.  Bound, as
    ``PERF.md`` counts it at mamba2-2.7b width (80 heads, S 1024, bf16):
    bytes, 24.44 MB = 7.3 us; the split adds the carried states (5.24 MB
    there, see :func:`carried_bytes`).

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
CHUNK = 64           # tokens per chunk of the kernel (csrc/ssd.cu Q)
BLOCKS_PER_SM = 2    # bf16 blocks an SM holds (csrc/ssd.cu tc::ssd_tc_kernel)
STATE_FLOATS = 128 * 64   # floats of one carried state (tc::PART)

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def ssd_plain(x, log_a, B, C, *, chunk: int, initial_state=None):
    """x: (BH, S, P); log_a: (BH, S); B/C: (BH, S, N); initial_state:
    (BH, N, P) or None (zeros).  Returns (y (BH, S, P) in x's dtype, final
    state (BH, N, P) f32; float64 for float64 operands, the precision of
    ``tests/test_torch_ssd_bwd.py``'s gradcheck).  A ragged tail is
    zero-padded to a whole chunk: log_a = 0 and x = 0 there give decay 1
    and no input."""
    bh, s, p = x.shape
    n = B.shape[-1]
    dev = x.device
    acc = torch.promote_types(x.dtype, torch.float32)
    state = (torch.zeros((bh, n, p), dtype=acc, device=dev)
             if initial_state is None else initial_state.to(acc))
    if s == 0:
        return x.clone(), state
    chunk = min(chunk, s)
    xp, lap, Bp, Cp = (_pad_to(t, chunk, 1) for t in (x, log_a, B, C))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    ys = []
    for c0 in range(0, xp.shape[1], chunk):
        xb = xp[:, c0:c0 + chunk].to(acc)
        lab = lap[:, c0:c0 + chunk].to(acc)
        Bb = Bp[:, c0:c0 + chunk].to(acc)
        Cb = Cp[:, c0:c0 + chunk].to(acc)
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


def pieces(bh: int, s: int, sms: int) -> tuple[int, int]:
    """How the bf16 kernel cuts each of ``bh`` rows of ``s`` tokens on a
    card of ``sms`` SMs: (pieces per row, 64-token chunks per piece).  As
    many pieces as the card holds blocks (``BLOCKS_PER_SM`` an SM) for all
    rows at once, at most one per chunk, none empty."""
    nch = -(-s // CHUNK)
    if nch == 0:
        return 1, 0
    want = max(1, min(nch, BLOCKS_PER_SM * sms // max(bh, 1)))
    cpp = -(-nch // want)
    return -(-nch // cpp), cpp


def carried_bytes(bh: int, s: int, sms: int) -> int:
    """Bytes of f32 state the bf16 kernel writes between its two passes
    (each piece but the last: one state and one decay product a row)."""
    g, _ = pieces(bh, s, sms)
    return bh * (g - 1) * (STATE_FLOATS + 1) * 4


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a 16-byte aligned base and row strides (the bf16 kernel's
    16-byte loads): as given, or copied into a zero buffer whose last axis
    is padded to a multiple of 8 and viewed back to its extent."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    n = t.shape[-1]
    buf = t.new_zeros((*t.shape[:-1], -(-n // 8) * 8))
    buf[..., :n] = t
    return buf[..., :n]


_SMS: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


_ARGS = ([_build.I] + [_build.P] * 7 + [_build.LL] * 10 + [_build.I] * 7
         + [_build.P] * 2 + [_build.I, _build.P])


def launch(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None):
    """CUDA kernel.  x: (BH, S, P); log_a: (BH, S); B/C: (BH / r, S, N),
    row g shared by x rows g * r .. g * r + r - 1; any strides with a unit
    last axis.  x/B/C float32 or bfloat16 (one type); log_a and
    initial_state are taken in f32.  Returns (y (BH, S, P) in x's dtype,
    final state (BH, N, P) f32).  One call counts one launch, though bf16
    issues two kernels when a row is cut into more than one piece."""
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
    if dt == 1:
        x, B, C = (_rows16(t) for t in (x, B, C))
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
    g, cpp = pieces(bh, s, _sm_count(x.device)) if dt == 1 else (1, 0)
    part = dec = None
    if g > 1:
        part = torch.empty((bh, g - 1, STATE_FLOATS), dtype=torch.float32,
                           device=x.device)
        dec = torch.empty((bh, g - 1), dtype=torch.float32, device=x.device)
    fn = _build.bind(NAME, "ssd_launch", _ARGS)
    code = fn(dt, _build.ptr(x), _build.ptr(log_a), _build.ptr(B),
              _build.ptr(C), _build.ptr(st0), _build.ptr(y), _build.ptr(st),
              x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1),
              y.stride(0), y.stride(1), bh, s, n, p, bh // nb, g, cpp,
              _build.ptr(part), _build.ptr(dec), int(p % 8 == 0),
              _build.stream_of(x))
    launches += 1
    _build.check(code, NAME)
    return y, st
