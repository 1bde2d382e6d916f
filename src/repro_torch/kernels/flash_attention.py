"""Blockwise forward attention with an online softmax.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``, the
Pallas kernel at :84).  Queries are right-aligned with the keys
(``qpos = i + Sk - Sq``); causal and sliding-window masks.

  * :func:`flash_attention_plain` — the reference's
    ``ops._blockwise_attention_ref`` in plain PyTorch (GQA pre-expanded,
    any leading dims);
  * :func:`launch` — the CUDA kernel (``csrc/flash_attention.cu``), which
    reads K/V with fewer heads than Q in place (query head h uses KV head
    h // G) instead of materialising the repeat.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.roofline import KernelCost
from repro_torch.kernels import _build
from repro_torch.kernels.ops import NEG_INF, _pad_to
from repro_torch.kernels.pairs import visible_pairs

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:84"

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         with_lse: bool = False) -> KernelCost:
    """The work of one launch (the kernel table's bound): q, K, V read and
    O written once (and the f32 LSE with ``with_lse``), 4 D operations a
    visible (query, key) pair and query head (QK^T and PV).  q: (..., H,
    Sq, D), k / v: (..., KVH, Sk, D); only shapes and dtypes are read."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    rows = q.numel() // (sq * d) if q.numel() else 0
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    if with_lse:
        nbytes += 4 * rows * sq
    flops = 4 * rows * d * visible_pairs(sq, sk, causal=causal,
                                         window=window)
    return KernelCost(NAME, flops, nbytes)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, scale=None,
                          bk: int = 512, with_lse: bool = False):
    """q: (..., Sq, D); k/v: (..., Sk, D) with the same leading dims.
    Strip-mined online softmax over ``bk``-key strips.  ``with_lse``: also
    return the (..., Sq) f32 row log-sum-exp of the scaled scores, m +
    log(l) (the reference's ``_fwd`` residual, flash_ref.py:133-134)."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    bk = min(bk, sk)
    kp = _pad_to(k, bk, -2)
    vp = _pad_to(v, bk, -2)
    nkb = kp.shape[-2] // bk
    dev = q.device
    lead = q.shape[:-2]
    q32 = q.float() * scale
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    m = torch.full((*lead, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((*lead, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, sq, d), dtype=torch.float32, device=dev)
    ar = torch.arange(bk, device=dev)
    for jb in range(nkb):
        kb = kp[..., jb * bk:(jb + 1) * bk, :].float()
        vb = vp[..., jb * bk:(jb + 1) * bk, :].float()
        kpos = jb * bk + ar[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.einsum("...qd,...kd->...qk", q32, kb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("...qk,...kd->...qd",
                                                    p, vb)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    out = (acc / safe[..., None]).to(q.dtype)
    return (out, m + torch.log(safe)) if with_lse else out


_ARGS = ([_build.I, _build.I] + [_build.P] * 4 + [_build.LL] * 12
         + [_build.I] * 7 + [_build.F, _build.I, _build.P, _build.P])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           scale: Optional[float] = None, with_lse: bool = False):
    """CUDA kernel.  q: (B, H, Sq, D); k/v: (B, KVH, Sk, D) with KVH | H,
    any strides with a unit last axis.  Returns (B, H, Sq, D) in q's dtype
    (a permuted view of a (B, Sq, H, D) buffer); ``with_lse`` (training):
    (that, the (B, H, Sq) f32 row log-sum-exp), which the kernel writes
    after O without changing O's bits."""
    global launches
    _build.require_cuda(NAME, q, k, v)
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    dt = _build.dtype_code(q, k, v)
    _build.head_dim_ok(d)
    q, k, v, vec = _build.aligned(
        dt, *(_build.inner_contiguous(t) for t in (q, k, v)))
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.bind(NAME, "fa_launch", _ARGS)
    code = fn(dt, d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(o),
              q.stride(0), q.stride(2), q.stride(1),
              k.stride(0), k.stride(2), k.stride(1),
              v.stride(0), v.stride(2), v.stride(1),
              o.stride(0), o.stride(1), o.stride(2),
              b, kvh, h // kvh, sq, sk, int(bool(causal)), int(window or 0),
              float(scale), vec, _build.ptr(lse), _build.stream_of(q))
    launches += 1
    _build.check(code, NAME)
    o = o.permute(0, 2, 1, 3)
    return (o, lse) if with_lse else o
