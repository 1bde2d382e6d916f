"""The backward pass of the Mamba2 SSD chunked scan (dx, d log_a, dB, dC).

Counterpart of ``jax.vjp`` of the reference's ``_chunked_ssd_ref``
(``repro/kernels/ops.py:511``), the jnp scan its training path
differentiates (there is no Pallas backward).  With the forward's notation
(``csrc/ssd.cu``), a reverse scan over chunks carries dS, the gradient of
the state leaving the chunk:

  * :func:`ssd_bwd_plain` — the formulas written out in plain PyTorch, a
    loop over ``chunk``-token chunks (the chunk-start states from a
    forward loop first): the tests' oracle and the plain path's backward,
    never the card's training path;
  * :func:`launch` — the CUDA kernels (``csrc/ssd_bwd.cu``): the
    chunk-boundary states and state gradients into scratch, then one
    block per (chunk, B/C row, slice of its heads) summing dB and dC over
    the slice's heads in a fixed order, then the slices summed in order.
    No atomics: two runs give the same bits.  bf16 runs on the tensor
    cores (mma.sync m16n8k16): the states walk a row's chunks with the
    whole state in accumulators and tiles in a cp.async ring, writing each
    chunk's S0 and dS as hi and lo bf16 planes; every product with an f32
    operand takes those two bf16 terms
    (``tests/test_torch_ssd_bwd_numerics.py`` emulates it).  f32 runs on
    the CUDA cores.

``ops.ssd`` routes through :class:`ops._SSD` when an operand needs a
gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.roofline import KernelCost
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import _rows16, causal_pairs
from repro_torch.kernels.ops import NEG_INF, _pad_to

NAME = "ssd_bwd"
SOURCE = "src/repro_torch/kernels/csrc/ssd_bwd.cu"
REPLACES = "src/repro/kernels/ops.py:511"
MAX_STATE = 128      # d_state the kernel holds (csrc/ssd_bwd.cu NM)
MAX_HEADDIM = 64     # headdim the kernel holds (csrc/ssd_bwd.cu PM)
CHUNK = 64           # tokens per chunk (csrc/ssd_bwd.cu Q)
BLOCKS_PER_SM = 2    # f32 chunk blocks wanted an SM when choosing slices

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def cost(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
         C: torch.Tensor, dy: torch.Tensor) -> KernelCost:
    """The work of one launch (the kernel table's bound): x, dy, B, C,
    log_a read once, dx, dB, dC, d log_a written once; the products of
    the 64-token schedule, the Q x Q ones over the causal pairs only: per
    row and chunk five state-sized products (the two state recurrences,
    B^T x for S0 and C^T dy for dS, and the three carry products, B dS
    into dx, S0 dy into dC, dS x into dB), then dy x^T, G^T dy, W B, W^T
    C; C B^T once per B/C row and chunk.  x: (BH, S, P), B / C: (NB, S,
    N); only shapes and dtypes are read."""
    del C, dy
    bh, s, p = x.shape
    nb, n = B.shape[0], B.shape[-1]
    pairs = causal_pairs(s)
    nbytes = (3 * x.numel() * x.element_size()
              + 4 * B.numel() * B.element_size()
              + 2 * log_a.numel() * log_a.element_size())
    flops = (bh * (5 * 2 * s * n * p + 2 * pairs * (2 * p + 2 * n))
             + nb * 2 * pairs * n)
    return KernelCost(NAME, flops, nbytes)


def ssd_bwd_plain(x, log_a, B, C, dy, *, chunk: int, initial_state=None):
    """x, dy: (BH, S, P); log_a: (BH, S); B/C: (BH, S, N), one row a head;
    initial_state: (BH, N, P) or None (zeros), the forward's seed (no
    gradient is taken for it).  Returns (dx, dlog_a, dB, dC) in the dtypes
    of x, log_a, B and C, computed in f32 (float64 for float64 operands).
    The final state's gradient is zero.  A ragged tail is zero-padded to a
    whole chunk, as the forward pads it."""
    bh, s, p = x.shape
    n = B.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    if s == 0:
        return (torch.zeros_like(x), torch.zeros_like(log_a),
                torch.zeros_like(B), torch.zeros_like(C))
    chunk = min(chunk, s)
    xp, lap, Bp, Cp, gp = (_pad_to(t, chunk, 1).to(acc)
                           for t in (x, log_a, B, C, dy))
    nc = xp.shape[1] // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))

    def parts(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        cum = torch.cumsum(lap[:, sl], dim=-1)
        return xp[:, sl], Bp[:, sl], Cp[:, sl], gp[:, sl], cum, cum[:, -1]

    state = (torch.zeros((bh, n, p), dtype=acc, device=dev)
             if initial_state is None else initial_state.to(acc))
    starts = []
    for c in range(nc):
        xb, Bb, _, _, cum, total = parts(c)
        starts.append(state)
        w = torch.exp(total[:, None] - cum)[..., None] * Bb
        state = (torch.exp(total)[:, None, None] * state
                 + torch.einsum("bjn,bjp->bnp", w, xb))

    dS = torch.zeros((bh, n, p), dtype=acc, device=dev)
    out = []
    for c in reversed(range(nc)):
        xb, Bb, Cb, gb, cum, total = parts(c)
        s0 = starts[c]
        seg = torch.where(tri, cum[:, :, None] - cum[:, None, :], NEG_INF)
        lmat = torch.exp(seg)                                 # (BH, i, j)
        cb = torch.einsum("bin,bjn->bij", Cb, Bb)
        w = torch.einsum("bip,bjp->bij", gb, xb) * lmat       # W
        ecum = torch.exp(cum)
        wdec = torch.exp(total[:, None] - cum)
        dx = (torch.einsum("bij,bip->bjp", cb * lmat, gb)
              + wdec[..., None] * torch.einsum("bjn,bnp->bjp", Bb, dS))
        c_carry = ecum[..., None] * torch.einsum("bnp,bip->bin", s0, gb)
        b_carry = wdec[..., None] * torch.einsum("bnp,bjp->bjn", dS, xb)
        dC = torch.einsum("bij,bjn->bin", w, Bb) + c_carry
        dB = torch.einsum("bij,bin->bjn", w, Cb) + b_carry
        m = w * cb
        b_dot = (Bb * b_carry).sum(-1)
        dcum = m.sum(2) - m.sum(1) + (Cb * c_carry).sum(-1) - b_dot
        dtotal = torch.exp(total) * (dS * s0).sum((1, 2)) + b_dot.sum(-1)
        dcum[:, -1] += dtotal
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])
        dS = (torch.exp(total)[:, None, None] * dS
              + torch.einsum("bin,bip->bnp", Cb * ecum[..., None], gb))
        out.append((dx, dla, dB, dC))
    dx, dla, dB, dC = (torch.cat(ts[::-1], dim=1)[:, :s]
                       for ts in zip(*out))
    return (dx.to(x.dtype), dla.to(log_a.dtype), dB.to(B.dtype),
            dC.to(C.dtype))


def slices(r: int, nb: int, s: int, sms: int) -> tuple[int, int]:
    """How the chunk kernel cuts the ``r`` heads of each of ``nb`` B/C
    rows of ``s`` tokens on a card of ``sms`` SMs: (heads per slice,
    slices).  Enough (chunk, row, slice) blocks for ``BLOCKS_PER_SM`` an
    SM, at most one slice a head, none empty."""
    nch = -(-s // CHUNK)
    want = max(1, min(r, -(-BLOCKS_PER_SM * sms // max(nb * nch, 1))))
    hs = -(-r // want)
    return hs, -(-r // hs)


def tc_slices(r: int, nb: int, s: int, sms: int) -> tuple[int, int]:
    """How the bf16 chunk kernel (one block an SM, its heads one after
    another) cuts the ``r`` heads of each of ``nb`` B/C rows of ``s``
    tokens on ``sms`` SMs: (heads per slice, slices).  The cut that needs
    the fewest rounds of head work, waves of blocks x (heads a block + one
    for a block's set-up: B, C, C B^T and the first head's loads), among
    those the fewest slices; none empty."""
    nch = -(-s // CHUNK)
    best = None
    for hs in range(r, 0, -1):
        sl = -(-r // hs)
        cost = -(-nb * nch * sl // max(sms, 1)) * (hs + 1)
        if best is None or cost < best[0]:
            best = (cost, hs, sl)
    return best[1], best[2]


def cut(r: int, nb: int, s: int, sms: int, dtype) -> tuple[int, int]:
    """The chunk kernel's (heads per slice, slices) for operands of
    ``dtype``."""
    return (tc_slices if dtype == torch.bfloat16 else slices)(r, nb, s, sms)


_SMS: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


_ARGS = ([_build.I] + [_build.P] * 14 + [_build.LL] * 10 + [_build.I] * 7
         + [_build.P])


def launch(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, dy: torch.Tensor, *,
           initial_state: Optional[torch.Tensor] = None):
    """CUDA kernels.  x, dy: (BH, S, P); log_a: (BH, S); B/C: (BH / r, S,
    N), row g shared by x rows g * r .. g * r + r - 1, as the forward
    takes them; any strides with a unit last axis.  x/B/C/dy float32 or
    bfloat16 (one type); log_a and initial_state are taken in f32.
    Returns (dx (BH, S, P), dlog_a (BH, S) f32, dB, dC (BH / r, S, N)), dx
    / dB / dC in x's dtype, all contiguous.  One call counts one launch,
    though it issues three kernels."""
    global launches
    _build.require_cuda(NAME, x, log_a, B, C, dy, initial_state)
    bh, s, p = x.shape
    nb, _, n = B.shape
    if (C.shape != B.shape or log_a.shape != (bh, s) or B.shape[1] != s
            or dy.shape != x.shape):
        raise ValueError(f"ssd_bwd: shapes x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, dy {tuple(dy.shape)}")
    if nb < 1 or bh % nb:
        raise ValueError(f"ssd_bwd: {nb} B/C rows do not divide {bh} x rows")
    if n > MAX_STATE or p > MAX_HEADDIM:
        raise ValueError(f"ssd_bwd: d_state {n} / headdim {p} above the "
                         f"kernel's {MAX_STATE} / {MAX_HEADDIM}")
    dt = _build.dtype_code(x, B, C, dy)
    x, B, C, dy = (_build.inner_contiguous(t) for t in (x, B, C, dy))
    if dt == 1:
        x, B, C, dy = (_rows16(t) for t in (x, B, C, dy))
    log_a = log_a.float()
    st0 = None
    if initial_state is not None:
        if initial_state.shape != (bh, n, p):
            raise ValueError(f"ssd_bwd: initial_state "
                             f"{tuple(initial_state.shape)}, expected "
                             f"{(bh, n, p)}")
        st0 = initial_state.float().contiguous()
    dev = x.device
    dx = torch.empty((bh, s, p), dtype=x.dtype, device=dev)
    dla = torch.empty((bh, s), dtype=torch.float32, device=dev)
    dB = torch.empty((nb, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    if bh == 0 or s == 0:
        return dx, dla, dB, dC
    _build.int32_sizes(NAME, bh * s * p, nb * s * n)
    r = bh // nb
    nch = -(-s // CHUNK)
    hs, sl = cut(r, nb, s, _sm_count(dev), x.dtype)
    st = torch.empty((bh, nch, state_floats(n, p, x.dtype)),
                     dtype=torch.float32, device=dev)
    dst = torch.empty_like(st)
    pB = torch.empty((sl, nb, s, n), dtype=torch.float32, device=dev)
    pC = torch.empty_like(pB)
    fn = _build.bind(NAME, "ssd_bwd_launch", _ARGS)
    code = fn(dt, _build.ptr(x), _build.ptr(log_a), _build.ptr(B),
              _build.ptr(C), _build.ptr(dy), _build.ptr(st0), _build.ptr(dx),
              _build.ptr(dla), _build.ptr(dB), _build.ptr(dC),
              _build.ptr(st), _build.ptr(dst), _build.ptr(pB),
              _build.ptr(pC), x.stride(0), x.stride(1), log_a.stride(0),
              log_a.stride(1), B.stride(0), B.stride(1), C.stride(0),
              C.stride(1), dy.stride(0), dy.stride(1), bh, s, n, p, r, hs,
              sl, _build.stream_of(x))
    launches += 1
    _build.check(code, NAME)
    return dx, dla, dB, dC


def state_floats(n: int, p: int, dtype=torch.float32) -> int:
    """Floats of scratch one chunk's state takes: f32 (N, P), or in bf16
    a hi and a lo bf16 plane of (P, N) rounded up to 16 x 16."""
    if dtype == torch.bfloat16:
        return -(-p // 16) * 16 * (-(-n // 16) * 16)
    return n * p


def scratch_bytes(bh: int, nb: int, s: int, n: int, p: int, sms: int,
                  dtype=torch.float32) -> int:
    """Bytes of scratch one call writes: the chunk-boundary states and
    their gradients, and the slices' f32 partial dB / dC."""
    nch = -(-s // CHUNK)
    _, sl = cut(bh // nb, nb, s, sms, dtype)
    return 4 * (2 * bh * nch * state_floats(n, p, dtype)
                + 2 * sl * nb * s * n)
