"""Public kernel API: dispatch by device + tail padding.

Port of ``repro/kernels/ops.py`` for the kernels of the serving path, with
the reference's argument layouts:

  * :func:`attention` — (..., S, D) attention (ops.py:194), with a
    gradient when an operand requires one: the forward kernel also writes
    the row log-sum-exp and the backward is ``flash_attention_bwd``'s
    kernel (the reference's training path, ``flash_ref.flash_attention_ref``
    with its custom VJP, flash_ref.py:68-225);
  * :func:`flash_decode` — (B, H, hd) queries over a (B, S, KVH, hd) cache
    with per-slot ``lengths`` (ops.py:324);
  * :func:`flash_prefill_chunk` — (B, C, H, hd) chunk queries over the
    arena with a runtime ``prefix`` (ops.py:450);
  * :func:`ssd` — the Mamba2 SSD chunked scan (ops.py:555), with a
    gradient when an operand requires one: the backward is ``ssd_bwd``'s
    kernel (the reference differentiates its jnp scan, ``jax.vjp`` of
    ``_chunked_ssd_ref``, ops.py:511); and :func:`ssd_decode_step`, its
    one-token recurrence (ops.py:578; plain PyTorch on every device, as
    the reference leaves it to XLA);

and for the paper's own vector-unit workloads:

  * :func:`matmul` — fmatmul, (M, K) x (K, N) (ops.py:67);
  * :func:`dotp` — the chained multiply + reduce dot product (ops.py:87);
  * :func:`conv2d` — fconv2d, valid NHWC x HWIO (ops.py:104).

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain PyTorch version (the counterpart of the reference's ``ref`` mode),
CUDA tensors launch the hand-written kernel or raise.  There is no mode
switch and no fallback.  :data:`PLAIN` bundles the plain versions behind
the same signatures for callers that want them on any device (a model built
with ``kernels=ops.PLAIN`` is the on-card oracle of the kernel path).

GQA folding: consecutive G query heads share a KV head (ops.py:348, :476).
The kernels index the KV head in place; the plain versions fold exactly as
the reference does.
"""
from __future__ import annotations

import types
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult`` (the RVV
    tail; the plain versions strip-mine in whole strips)."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    cfg = [0, 0] * (x.ndim - axis)
    cfg[-1] = pad                        # F.pad lists the last axis first
    return F.pad(x, cfg)


# kernel modules import _pad_to / NEG_INF from here, so they come after
from repro_torch.kernels import flash_attention as _fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as _fab  # noqa: E402
from repro_torch.kernels import flash_decode as _fd  # noqa: E402
from repro_torch.kernels import flash_prefill_chunk as _fpc  # noqa: E402
from repro_torch.kernels import ssd as _ssd  # noqa: E402
from repro_torch.kernels import ssd_bwd as _ssdb  # noqa: E402
from repro_torch.kernels import matmul as _mm  # noqa: E402
from repro_torch.kernels import dotp as _dp  # noqa: E402
from repro_torch.kernels import conv2d as _cv  # noqa: E402

KERNEL_MODULES = (_fa, _fab, _fd, _fpc, _ssd, _ssdb, _mm, _dp, _cv)
#: the kernels with a fused-dequant branch: their scaled launches (over an
#: int8 / fp8 arena) are also counted apart, as ``<name>_scaled``
SCALED_MODULES = (_fd, _fpc)
#: the kernels with a donor table (prefix sharing): the launches with one
#: are also counted apart, as ``<name>_donor``
DONOR_MODULES = (_fd, _fpc)
#: the kernel of a speculative verify pass: its launches inside
#: ``verify_pass()`` are also counted apart, as ``<name>_verify``
VERIFY_MODULES = (_fpc,)
verify_pass = _fpc.verify_pass


def _counters():
    """(count name, module, attribute) of every launch counter."""
    return ([(m.NAME, m, "launches") for m in KERNEL_MODULES]
            + [(m.NAME + "_scaled", m, "launches_scaled")
               for m in SCALED_MODULES]
            + [(m.NAME + "_donor", m, "launches_donor")
               for m in DONOR_MODULES]
            + [(m.NAME + "_verify", m, "launches_verify")
               for m in VERIFY_MODULES])


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}, {``<name>_scaled``:
    the scaled ones among them} for the kernels of ``SCALED_MODULES``,
    {``<name>_donor``: those with a donor table} for ``DONOR_MODULES`` and
    {``<name>_verify``: those of a verify pass} for ``VERIFY_MODULES``."""
    return {name: getattr(m, attr) for name, m, attr in _counters()}


def reset_launch_counts() -> None:
    for _, m, attr in _counters():
        setattr(m, attr, 0)


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` {count name: launches} to the counters: a CUDA graph
    replay launches the kernels its capture recorded with no wrapper call
    to count them (``runtime/serving/graphs.py``)."""
    for name, m, attr in _counters():
        setattr(m, attr, getattr(m, attr) + delta.get(name, 0))


def _on_cuda(*ts) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in ts if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on unsupported/mixed devices: {kinds}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _expand_gqa(q, k, v):
    """Repeat K/V heads (axis -3) to q's head count: consecutive G query
    heads share one KV head, as ``jnp.repeat(k, G, axis=2)``."""
    if q.ndim < 3 or k.shape[-3] == q.shape[-3]:
        return k, v
    h, kvh = q.shape[-3], k.shape[-3]
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    g = h // kvh
    return (k.repeat_interleave(g, dim=-3), v.repeat_interleave(g, dim=-3))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                     bq=256, bk=512):
    del bq
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, scale, True, bk)
    k, v = _expand_gqa(q, k, v)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, bk=bk)


def _fold4(*ts):
    """(..., H, S, D) operands as 4-D (B, H, S, D) views."""
    if ts[0].ndim == 3:
        return tuple(t[None] for t in ts)
    if ts[0].ndim == 4:
        return ts
    return tuple(t.reshape(-1, *t.shape[-3:]) for t in ts)


def _attention_bwd_plain(q, k, v, o, lse, dout, *, causal, window, scale,
                         bk=512):
    """``flash_attention_bwd_plain`` with GQA: K/V expanded to q's heads
    as the reference's ``jnp.repeat``, and dK / dV summed back over each
    KV head's G query heads (the repeat's transpose)."""
    ke, ve = _expand_gqa(q, k, v)
    dq, dk, dv = _fab.flash_attention_bwd_plain(
        q.float(), ke.float(), ve.float(), o.float(), lse, dout.float(),
        causal=causal, window=window, scale=scale, bk=bk)
    if ke is not k:
        kvh = k.shape[-3]
        g = q.shape[-3] // kvh
        dk, dv = (t.reshape(*t.shape[:-3], kvh, g, *t.shape[-2:]).sum(-3)
                  for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_forward(q, k, v, *, causal, window, scale, plain, bk):
    """(O, LSE) of attention with a gradient: ``plain`` or CPU operands
    the plain version, CUDA operands the forward kernel with its LSE
    output.  The forward body of :class:`_Attention`, over tensors."""
    if plain or not _on_cuda(q, k, v):
        ke, ve = _expand_gqa(q, k, v)
        return _fa.flash_attention_plain(q, ke, ve, causal=causal,
                                         window=window, scale=scale, bk=bk,
                                         with_lse=True)
    q4, k4, v4 = _fold4(q, k, v)
    out, lse = _fa.launch(q4, k4, v4, causal=causal, window=window,
                          scale=scale, with_lse=True)
    return out.reshape(q.shape), lse.reshape(q.shape[:-1])


def attention_backward(q, k, v, out, lse, dout, *, causal, window, scale,
                       plain, bk):
    """(dQ, dK, dV) from the forward's O and LSE: ``plain`` or CPU operands
    the plain version, CUDA operands the backward kernel.  The backward
    body of :class:`_Attention`, over tensors."""
    if plain or not _on_cuda(q, k, v, dout):
        return _attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                    window=window, scale=scale, bk=bk)
    q4, k4, v4, o4, g4 = _fold4(q, k, v, out, dout)
    dq, dk, dv = _fab.launch(q4, k4, v4, o4, lse.reshape(q4.shape[:-1]), g4,
                             causal=causal, window=window, scale=scale)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


class _Attention(torch.autograd.Function):
    """Attention with a gradient (the reference's ``flash_attention_ref``
    custom VJP, flash_ref.py:68-225): the forward saves (q, k, v, O, LSE),
    the backward recomputes P from the LSE.  ``plain``: both passes in
    plain PyTorch on any device (the oracle path); otherwise CUDA
    operands take the forward kernel with its LSE output and the backward
    kernel, CPU operands the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, plain, bk):
        out, lse = attention_forward(q, k, v, causal=causal, window=window,
                                     scale=scale, plain=plain, bk=bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        plain=plain, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = attention_backward(*ctx.saved_tensors, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, bq: int = 256,
              bk: int = 512) -> torch.Tensor:
    """Multi-head attention over (..., S, D) tensors.

    As in the reference, the leading dims are batch/head and GQA may be
    pre-expanded; in addition the head axis (-3) of k/v may hold KVH heads
    dividing q's H, which the kernel reads in place (head h -> h // G).
    When an operand requires a gradient (training), the call goes through
    :class:`_Attention`: on the card the forward kernel with its LSE
    output, then the backward kernel; serving calls never do.
    """
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, scale, False, bk)
    if not _on_cuda(q, k, v):
        return _attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale, bq=bq, bk=bk)
    q4, k4, v4 = _fold4(q, k, v)
    out = _fa.launch(q4, k4, v4, causal=causal, window=window, scale=scale)
    return out.reshape(*q.shape[:-2], *out.shape[-2:])


# ---------------------------------------------------------------------------
# flash-decode (serving decode step; per-slot length masking)
# ---------------------------------------------------------------------------

def _flash_decode_plain(q, k, v, *, lengths=None, window=None, scale=None,
                        bk=512, k_scale=None, v_scale=None, share_src=None,
                        share_len=None):
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    qg = q.reshape(b, kvh, h // kvh, hd)
    out = _fd.flash_decode_plain(qg, k, v, lengths=lengths, window=window,
                                 scale=scale, bk=bk, k_scale=k_scale,
                                 v_scale=v_scale, share_src=share_src,
                                 share_len=share_len)
    return out.reshape(b, h, hd)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 lengths: Optional[torch.Tensor] = None,
                 window: Optional[int] = None,
                 scale: Optional[float] = None, bk: int = 512,
                 k_scale=None, v_scale=None, share_src=None,
                 share_len=None) -> torch.Tensor:
    """One-token decode attention with per-sequence length masking.

    q: (B, H, hd); k/v: (B, S, KVH, hd); lengths: (B,) live KV rows per
    sequence (None = all S).  Returns (B, H, hd).  Lengths past S (a
    parked slot) attend all S rows and never read beyond them.

    ``k_scale`` / ``v_scale``: (B, S, KVH) f32 dequant scales of a scaled
    arena (int8 or fp8 K/V, ``core/kv_format.py``): each K/V row is
    widened and multiplied by its scale inside the kernel, so the arena is
    never widened in memory (reference ops.py:324-360).

    ``share_src`` / ``share_len``: (B,) int donor table (prefix sharing):
    slot b reads rows [0, share_len[b]) of K, V and the scales from slot
    ``share_src[b]``, the rest from its own (an unshared slot: (b, 0));
    None reads every slot's own rows.  Writes never go through it.
    """
    if not _on_cuda(q, k, v, lengths, k_scale, v_scale, share_src,
                    share_len):
        return _flash_decode_plain(q, k, v, lengths=lengths, window=window,
                                   scale=scale, bk=bk, k_scale=k_scale,
                                   v_scale=v_scale, share_src=share_src,
                                   share_len=share_len)
    return _fd.launch(q, k, v, lengths, window=window, scale=scale,
                      k_scale=k_scale, v_scale=v_scale, share_src=share_src,
                      share_len=share_len)


# ---------------------------------------------------------------------------
# flash-prefill-chunk (chunked prompt ingestion; dynamic causal boundary)
# ---------------------------------------------------------------------------

def _flash_prefill_chunk_plain(q, k, v, *, prefix, window=None, scale=None,
                               bk=512, k_scale=None, v_scale=None,
                               slots=None, share_src=None, share_len=None):
    b, c, h, hd = q.shape
    _, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    g = h // kvh
    # (B, C, H, hd) -> (B, KVH, G, C, hd): consecutive G heads share a KV head
    qg = q.transpose(1, 2).reshape(b, kvh, g, c, hd)
    out = _fpc.flash_prefill_chunk_plain(qg, k, v, prefix=prefix,
                                         window=window, scale=scale, bk=bk,
                                         k_scale=k_scale, v_scale=v_scale,
                                         slots=slots, share_src=share_src,
                                         share_len=share_len)
    return out.reshape(b, h, c, hd).transpose(1, 2)


def flash_prefill_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, prefix: torch.Tensor,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, bk: int = 512,
                        k_scale=None, v_scale=None,
                        slots: Optional[torch.Tensor] = None,
                        share_src: Optional[torch.Tensor] = None,
                        share_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Chunk-append prefill attention with a runtime causal boundary.

    q: (B, C, H, hd); k/v: (B, S, KVH, hd) with the chunk's K/V already at
    rows [prefix, prefix + C); prefix: (B,) rows live before the chunk.
    Returns (B, C, H, hd).  ``k_scale`` / ``v_scale``: as for
    :func:`flash_decode`.  ``slots`` (B,) int: k/v (and the scales) are
    the whole arena (N, S, KVH, hd) and batch b reads its row
    ``slots[b]`` (None: row b of a (B, ...) arena).  ``share_src`` /
    ``share_len`` (B,) int: the donor table, as for :func:`flash_decode`
    (batch b's rows [0, share_len[b]) from arena row ``share_src[b]``).
    """
    if not _on_cuda(q, k, v, prefix, k_scale, v_scale, slots, share_src,
                    share_len):
        return _flash_prefill_chunk_plain(q, k, v, prefix=prefix,
                                          window=window, scale=scale, bk=bk,
                                          k_scale=k_scale, v_scale=v_scale,
                                          slots=slots, share_src=share_src,
                                          share_len=share_len)
    return _fpc.launch(q, k, v, prefix, window=window, scale=scale,
                       k_scale=k_scale, v_scale=v_scale, slots=slots,
                       share_src=share_src, share_len=share_len)


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------

def _group_factor(x, B) -> int:
    """r: how many x rows share each B/C row."""
    bh, nb = x.shape[0], B.shape[0]
    if nb < 1 or bh % nb:
        raise ValueError(f"ssd: {nb} B/C rows do not divide {bh} rows")
    return bh // nb


def _ssd_plain(x, log_a, B, C, *, chunk=256, initial_state=None):
    if _needs_grad(x, log_a, B, C, initial_state):
        return _SSD.apply(x, log_a, B, C, initial_state, chunk, True)
    r = _group_factor(x, B)
    if r > 1:
        B = B.repeat_interleave(r, dim=0)
        C = C.repeat_interleave(r, dim=0)
    return _ssd.ssd_plain(x, log_a, B, C, chunk=chunk,
                          initial_state=initial_state)


def _ssd_bwd_plain(x, log_a, B, C, dy, *, chunk, initial_state=None):
    """``ssd_bwd_plain`` with shared B/C rows: each row repeated to its r
    heads (the reference's broadcast), and dB / dC summed back over them
    in f32 (the broadcast's transpose) before the one rounding to their
    dtype."""
    r = _group_factor(x, B)
    acc = torch.promote_types(B.dtype, torch.float32)
    Be, Ce = (t.to(acc).repeat_interleave(r, dim=0) for t in (B, C))
    dx, dla, dB, dC = _ssdb.ssd_bwd_plain(x, log_a, Be, Ce, dy, chunk=chunk,
                                          initial_state=initial_state)
    dB, dC = (t.reshape(B.shape[0], r, *t.shape[1:]).sum(1).to(B.dtype)
              for t in (dB, dC))
    return dx, dla, dB, dC


def ssd_forward(x, log_a, B, C, initial_state, *, chunk, plain):
    """(y, final state) of the SSD scan with a gradient: ``plain`` or CPU
    operands the plain version, CUDA operands the ``ssd`` kernel.  The
    forward body of :class:`_SSD`, over tensors, called with autograd off
    (inside an autograd Function's forward)."""
    if plain or not _on_cuda(x, log_a, B, C, initial_state):
        return _ssd_plain(x, log_a, B, C, chunk=chunk,
                          initial_state=initial_state)
    return _ssd.launch(x, log_a, B, C, initial_state=initial_state)


def ssd_backward(x, log_a, B, C, initial_state, dy, *, chunk, plain):
    """(dx, dlog_a, dB, dC) of the SSD scan: ``plain`` or CPU operands the
    plain version, CUDA operands the ``ssd_bwd`` kernel.  The backward
    body of :class:`_SSD`, over tensors."""
    if plain or not _on_cuda(x, log_a, B, C, dy, initial_state):
        dx, dla, dB, dC = _ssd_bwd_plain(x, log_a, B, C, dy, chunk=chunk,
                                         initial_state=initial_state)
    else:
        dx, dla, dB, dC = _ssdb.launch(x, log_a, B, C, dy,
                                       initial_state=initial_state)
    return dx, dla.to(log_a.dtype), dB, dC


def ssd_no_state_grad(dstate, needs_initial_grad: bool) -> None:
    """Raise where a gradient reaches the initial or the final state."""
    if dstate is not None or needs_initial_grad:
        raise NotImplementedError(
            "ssd: no gradient is taken through the initial or the final "
            "state (training passes no initial state and drops the "
            "final one, as the reference's mamba_apply does)")


class _SSD(torch.autograd.Function):
    """The SSD scan with a gradient for x, log_a, B and C (the reference
    differentiates ``_chunked_ssd_ref``'s jnp scan, ops.py:511).  The
    forward saves its inputs and recomputes the rest in the backward.
    ``plain``: both passes in plain PyTorch on any device (the oracle
    path); otherwise CUDA operands take the ``ssd`` kernel and the
    ``ssd_bwd`` kernel, CPU operands the plain versions.  Training passes
    no initial state and drops the final one (reference ``mamba_apply``):
    a gradient that reaches either raises ``NotImplementedError``."""

    @staticmethod
    def forward(ctx, x, log_a, B, C, initial_state, chunk, plain):
        y, st = ssd_forward(x, log_a, B, C, initial_state, chunk=chunk,
                            plain=plain)
        ctx.save_for_backward(x, log_a, B, C, initial_state)
        ctx.opts = dict(chunk=chunk, plain=plain)
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        ssd_no_state_grad(dstate, ctx.needs_input_grad[4])
        if dy is None:
            return (None,) * 7
        grads = ssd_backward(*ctx.saved_tensors, dy, **ctx.opts)
        return (*grads, None, None, None)


def ssd(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 256,
        initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD: x (BH, S, P), log_a (BH, S), B/C (BH, S, N) -> (y,
    final state f32 (BH, N, P)); ``initial_state`` (BH, N, P) seeds the
    recurrence (serving's chunked prefill threads it across chunks).

    As in the reference, any S is accepted; on the card the kernel masks a
    ragged tail itself (no fallback), where the reference's ``ops.ssd``
    gives way to its jnp path (ops.py:570).  In addition B/C may hold
    BH / r rows, row g shared by x rows g * r .. g * r + r - 1 (n_groups <
    n_heads), which the kernel reads in place.  ``chunk`` is the plain
    version's chunk; the kernel's chunk is its own (64 tokens), and in
    bf16 its f32 operands enter the tensor cores as two bf16 terms: the
    result differs only by rounding (~2^-17 relative per term).

    When an operand requires a gradient (training), the call goes through
    :class:`_SSD`: on the card the ``ssd`` kernel, then the ``ssd_bwd``
    kernel; serving calls never do.
    """
    if _needs_grad(x, log_a, B, C, initial_state):
        return _SSD.apply(x, log_a, B, C, initial_state, chunk, False)
    if not _on_cuda(x, log_a, B, C, initial_state):
        return _ssd_plain(x, log_a, B, C, chunk=chunk,
                          initial_state=initial_state)
    return _ssd.launch(x, log_a, B, C, initial_state=initial_state)


def ssd_decode_step(x_t, log_a_t, B_t, C_t, state):
    """Single-token SSD recurrence (O(N·P) per head): x_t (BH, P), log_a_t
    (BH,), B_t/C_t (BH, N), state (BH, N, P) f32.  Returns (y (BH, P) in
    x_t's dtype, new state f32).  Plain PyTorch on every device, as in the
    reference (jnp there); the state is returned, not written: the caller
    writes it into its arena (masked for parked slots)."""
    state = (torch.exp(log_a_t.float())[:, None, None] * state
             + B_t.float()[:, :, None] * x_t.float()[:, None, :])
    y = torch.einsum("bn,bnp->bp", C_t.float(), state)
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# the vector-unit kernels: fmatmul, dot product, fconv2d
#
# The TPU kernels' block arguments (bm/bk/bn, strip, bh/bw) are accepted
# for the reference's signatures and have no effect: the CUDA kernels tile
# themselves and mask ragged edges inside, where the reference zero-pads
# to whole blocks (ops.py:75-80, :94-96, :112-118) — padded zeros add
# exact zeros, so the function is the same.
# ---------------------------------------------------------------------------

def _matmul_plain(a, b, *, bm=256, bk=512, bn=256):
    del bm, bk, bn
    return _mm.matmul_plain(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
           bk: int = 512, bn: int = 256) -> torch.Tensor:
    """C = A @ B: a (M, K), b (K, N) -> (M, N) in a's dtype, accumulated
    in float32.  The CUDA kernel takes float32 or bfloat16 (one type for
    both) and multiplies float32 in float32, never TF32."""
    if not _on_cuda(a, b):
        return _matmul_plain(a, b)
    return _mm.launch(a, b)


def _dotp_plain(a, b, *, strip=16 * 8 * 128):
    del strip
    return _dp.dotp_plain(a, b)


def dotp(a: torch.Tensor, b: torch.Tensor, *,
         strip: int = 16 * 8 * 128) -> torch.Tensor:
    """Dot product of two (n,) vectors -> 0-d float32 (inputs widened to
    float32 before the multiply)."""
    if not _on_cuda(a, b):
        return _dotp_plain(a, b)
    return _dp.launch(a, b)


def _conv2d_plain(x, w, *, bh=8, bw=128):
    del bh, bw
    return _cv.conv2d_plain(x, w)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, bh: int = 8,
           bw: int = 128) -> torch.Tensor:
    """Valid convolution: x (N, H, W, Cin) x w (KH, KW, Cin, Cout) ->
    (N, H - KH + 1, W - KW + 1, Cout) in x's dtype, accumulated in
    float32."""
    if not _on_cuda(x, w):
        return _conv2d_plain(x, w)
    return _cv.launch(x, w)


#: the plain versions behind the public signatures, on any device — the
#: oracle a model is built with (``kernels=ops.PLAIN``) to check the
#: kernel path on the card; the serving path never uses it
PLAIN = types.SimpleNamespace(attention=_attention_plain,
                              flash_decode=_flash_decode_plain,
                              flash_prefill_chunk=_flash_prefill_chunk_plain,
                              ssd=_ssd_plain,
                              ssd_decode_step=ssd_decode_step,
                              matmul=_matmul_plain,
                              dotp=_dotp_plain,
                              conv2d=_conv2d_plain)
