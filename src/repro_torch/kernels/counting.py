"""The counting kernel bundle: each kernel call charged once to the
active cost mode (``core/cost.py``) from its module's ``cost()``.

:func:`counting_kernels` has ``ops``' signatures, so a model built with
``kernels=counting_kernels()`` runs the step the dry run and the card's
analysis phase trace.  Inside each call the dispatch modes are paused, so
the kernel's own ops (the plain version's on the CPU) are not charged on
top of its work; on meta tensors, where no kernel can run (``ops`` raises
there), the call returns empty outputs of the right shapes.  The outputs
come in the kernel's layout on every device, so the ops after the call
count the same on meta, on the CPU and on the card.  With a gradient,
:class:`_CountedAttention` and :class:`_CountedSSD` run ``ops``' forward
and backward bodies (``ops.attention_forward`` / ``attention_backward``,
``ops.ssd_forward`` / ``ssd_backward``) and charge each backward kernel
once.  The main path never builds this bundle.
"""
from __future__ import annotations

import types

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core import cost
from repro_torch.kernels import (conv2d, dotp, flash_attention,
                                 flash_attention_bwd, flash_decode,
                                 flash_prefill_chunk, matmul, ops, ssd,
                                 ssd_bwd)


def _on_meta(*ts) -> bool:
    return any(t is not None and t.device.type == "meta" for t in ts)


def _charge(work, outs) -> None:
    mode = cost.active()
    if mode is not None:
        mode.charge_kernel(work, outs)


def _paused():
    """The dispatch modes off: the kernel's own ops are not charged."""
    return _disable_current_modes()


def _empty(shape, like, dtype=None, heads_major=False):
    """An empty tensor laid out as the CUDA kernel writes its output:
    contiguous, or (``heads_major``, the attention kernels' (..., H, S, D)
    outputs) a (B, S, H, D) buffer viewed head-major."""
    dtype = dtype or like.dtype
    if not heads_major:
        return torch.empty(shape, dtype=dtype, device=like.device)
    *lead, h, s, d = shape
    b = 1
    for n in lead:
        b *= n
    buf = torch.empty((b, s, h, d), dtype=dtype, device=like.device)
    return buf.transpose(1, 2).reshape(shape)


def _as_kernel(real, empty):
    """The kernel call's output in the kernel's layout: on meta (``real``
    None) the empty tensor, elsewhere ``real`` when it has that layout
    already (the kernel's own output on the card), else copied into it (a
    plain version's output on the CPU), so the ops after the call see the
    same strides, and count the same, on every device."""
    if real is None:
        return empty
    if real.stride() == empty.stride() and real.dtype == empty.dtype:
        return real
    return empty.copy_(real)


class _CountedAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel (with its LSE) charged
    once each time it runs (a checkpoint's recompute runs it again, as on
    the card), the backward kernel once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bk):
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        plain=False, bk=bk)
        with _paused():
            real = (None, None) if _on_meta(q, k, v) else \
                ops.attention_forward(q, k, v, **ctx.opts)
            out, lse = (_as_kernel(r, e) for r, e in zip(real, (
                _empty(q.shape, q, heads_major=True),
                _empty(q.shape[:-1], q, dtype=torch.float32))))
        ctx.save_for_backward(q, k, v, out, lse)
        _charge(flash_attention.cost(q, k, v, causal=causal, window=window,
                                     with_lse=True), (out, lse))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors   # unpacked once (checkpoint)
        with _paused():
            work = flash_attention_bwd.cost(
                q, k, v, out, lse, dout, causal=ctx.opts["causal"],
                window=ctx.opts["window"])
            real = (None,) * 3 if _on_meta(q, k, v) else \
                ops.attention_backward(q, k, v, out, lse, dout, **ctx.opts)
            grads = tuple(_as_kernel(r, _empty(t.shape, t, heads_major=True))
                          for r, t in zip(real, (q, k, v)))
        _charge(work, grads)
        return (*grads, None, None, None, None)


def _ssd_outs(x, B):
    return (_empty(x.shape, x),
            _empty((x.shape[0], B.shape[-1], x.shape[-1]), x,
                   dtype=torch.float32))


class _CountedSSD(torch.autograd.Function):
    """The SSD scan with a gradient: ``ssd`` charged each time the forward
    runs, ``ssd_bwd`` once in the backward."""

    @staticmethod
    def forward(ctx, x, log_a, B, C, initial_state, chunk):
        ctx.opts = dict(chunk=chunk, plain=False)
        with _paused():
            real = (None, None) if _on_meta(x, log_a, B, C) else \
                ops.ssd_forward(x, log_a, B, C, initial_state, **ctx.opts)
            y, st = (_as_kernel(r, e) for r, e in zip(real,
                                                      _ssd_outs(x, B)))
        ctx.save_for_backward(x, log_a, B, C, initial_state)
        ctx.set_materialize_grads(False)
        _charge(ssd.cost(x, log_a, B, C, initial_state=initial_state),
                (y, st))
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        ops.ssd_no_state_grad(dstate, ctx.needs_input_grad[4])
        if dy is None:
            return (None,) * 6
        x, log_a, B, C, st0 = ctx.saved_tensors  # unpacked once (checkpoint)
        with _paused():
            work = ssd_bwd.cost(x, log_a, B, C, dy)
            real = (None,) * 4 if _on_meta(x, log_a, B, C) else \
                ops.ssd_backward(x, log_a, B, C, st0, dy, **ctx.opts)
            grads = tuple(_as_kernel(r, _empty(t.shape, t))
                          for r, t in zip(real, (x, log_a, B, C)))
        _charge(work, grads)
        return (*grads, None, None)


def counting_kernels(*, naive_attention: bool = False):
    """A kernel bundle with ``kernels/ops.py``'s signatures (a model's
    ``kernels=``) that charges each kernel call to the active
    ``core.cost.CostMode`` from its module's ``cost()`` and runs ``ops``'
    version (the kernels on the card, the plain versions on the CPU) with
    the mode paused, or on meta tensors returns empty outputs of the right
    shapes; either way the outputs come in the kernel's layout.  The
    data-dependent extents are taken at their most (every slot's arena
    rows live, a chunk at the arena's last rows), as a costed call reads
    no tensor's values.  ``naive_attention``: attention runs
    ``ops.PLAIN.attention`` with the mode on, so its plain aten ops are
    charged in place of the kernel's cost (the reference's ``--attn-impl
    naive``)."""

    def run(work, fn, empties, *ts):
        with _paused():
            meta = _on_meta(*ts)
            outs = empties()
            single = isinstance(outs, torch.Tensor)
            outs = (outs,) if single else outs
            real = (None,) * len(outs) if meta else fn()
            real = (real,) if single and not meta else real
            outs = tuple(_as_kernel(r, e) for r, e in zip(real, outs))
        _charge(work, outs)
        return outs[0] if single else outs

    def attention(q, k, v, *, causal=True, window=None, scale=None,
                  bq=256, bk=512):
        if naive_attention:
            return ops.PLAIN.attention(q, k, v, causal=causal,
                                       window=window, scale=scale, bq=bq,
                                       bk=bk)
        if ops._needs_grad(q, k, v):
            return _CountedAttention.apply(q, k, v, causal, window, scale,
                                           bk)
        return run(flash_attention.cost(q, k, v, causal=causal,
                                        window=window),
                   lambda: ops.attention(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         bq=bq, bk=bk),
                   lambda: _empty(q.shape, q, heads_major=True), q, k, v)

    def decode(q, k, v, *, lengths=None, window=None, scale=None, bk=512,
               k_scale=None, v_scale=None, share_src=None, share_len=None):
        work = flash_decode.cost(q, k, None, window=window, k_scale=k_scale)
        return run(work, lambda: ops.flash_decode(
            q, k, v, lengths=lengths, window=window, scale=scale, bk=bk,
            k_scale=k_scale, v_scale=v_scale, share_src=share_src,
            share_len=share_len), lambda: _empty(q.shape, q), q, k, v)

    def chunk(q, k, v, *, prefix, window=None, scale=None, bk=512,
              k_scale=None, v_scale=None, slots=None, share_src=None,
              share_len=None):
        work = flash_prefill_chunk.cost(q, k, None, window=window,
                                        k_scale=k_scale)
        return run(work, lambda: ops.flash_prefill_chunk(
            q, k, v, prefix=prefix, window=window, scale=scale, bk=bk,
            k_scale=k_scale, v_scale=v_scale, slots=slots,
            share_src=share_src, share_len=share_len),
            lambda: _empty(q.shape, q), q, k, v)

    def ssd_(x, log_a, B, C, *, chunk=256, initial_state=None):
        if ops._needs_grad(x, log_a, B, C, initial_state):
            return _CountedSSD.apply(x, log_a, B, C, initial_state, chunk)
        return run(ssd.cost(x, log_a, B, C, initial_state=initial_state),
                   lambda: ops.ssd(x, log_a, B, C, chunk=chunk,
                                   initial_state=initial_state),
                   lambda: _ssd_outs(x, B), x, log_a, B, C)

    def matmul_(a, b, *, bm=256, bk=512, bn=256):
        return run(matmul.cost(a, b),
                   lambda: ops.matmul(a, b, bm=bm, bk=bk, bn=bn),
                   lambda: _empty((a.shape[0], b.shape[1]), a), a, b)

    def dotp_(a, b, *, strip=16 * 8 * 128):
        return run(dotp.cost(a, b), lambda: ops.dotp(a, b, strip=strip),
                   lambda: _empty((), a, dtype=torch.float32), a, b)

    def conv2d_(x, w, *, bh=8, bw=128):
        ho, wo = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
        return run(conv2d.cost(x, w),
                   lambda: ops.conv2d(x, w, bh=bh, bw=bw),
                   lambda: _empty((x.shape[0], ho, wo, w.shape[3]), x),
                   x, w)

    return types.SimpleNamespace(
        attention=attention, flash_decode=decode,
        flash_prefill_chunk=chunk, ssd=ssd_,
        ssd_decode_step=ops.ssd_decode_step, matmul=matmul_, dotp=dotp_,
        conv2d=conv2d_)
