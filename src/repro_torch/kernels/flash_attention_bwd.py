"""The backward pass of flash attention (dQ, dK, dV).

Counterpart of ``repro/kernels/flash_ref.py``'s ``_bwd_vjp`` (:150), the
custom VJP of ``flash_attention_ref`` that the reference's training path
differentiates through (jnp, not a Pallas kernel).  Same masks as the
forward (:mod:`repro_torch.kernels.flash_attention`): queries right-aligned
with the keys (``qpos = i + Sk - Sq``), causal and sliding window, keys
past Sk masked.

  * :func:`flash_attention_bwd_plain` — ``_bwd_vjp`` in plain PyTorch,
    strip-mined over ``bk``-key strips (GQA pre-expanded, any leading
    dims): the tests' oracle and the plain path's backward, never the
    card's training path;
  * :func:`launch` — the CUDA kernel (``csrc/flash_attention_bwd.cu``),
    which reads K/V with fewer heads than Q in place (query head h uses KV
    head h // G) and sums each KV head's gradient over its G query heads
    itself, with no atomics (two runs give the same bits).  bf16 runs on
    the tensor cores: wgmma over TMA-fed 64-row tiles, P and dS fed to
    their products as two bf16 terms each (hi + lo; one term misses the
    limit, ``tests/test_torch_tc_numerics.py``); f32 runs on the CUDA
    cores.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.roofline import KernelCost
from repro_torch.kernels import _build
from repro_torch.kernels.pairs import visible_pairs
from repro_torch.kernels.ops import _pad_to

NAME = "flash_attention_bwd"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_ref.py:150"

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None) -> KernelCost:
    """The work of one launch (the kernel table's bound): the work's 5
    products a visible pair (S = QK^T, dP = dO V^T, dV, dQ, dK), 2.5x the
    forward's 2, not the 10 the design does; bytes as the kernel table
    counts them: three q-sized and two O-sized tensors, K and V with their
    gradients, the f32 LSE.  Shapes as :func:`launch`'s; only
    shapes and dtypes are read."""
    del dout
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    rows = q.numel() // (sq * d) if q.numel() else 0
    fwd = 4 * rows * d * visible_pairs(sq, sk, causal=causal, window=window)
    nbytes = (q.element_size() * (3 * q.numel() + 2 * o.numel()
                                  + 2 * k.numel() + 2 * v.numel())
              + 4 * lse.numel())
    return KernelCost(NAME, int(2.5 * fwd), nbytes)


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal: bool = True,
                              window: Optional[int] = None, scale=None,
                              bk: int = 512):
    """q, o, dout: (..., Sq, D); k, v: (..., Sk, D) with the same leading
    dims; lse: (..., Sq) f32, the forward's row log-sum-exp of the scaled
    scores.  Returns (dq, dk, dv) in the operands' dtypes.  Per ``bk``-key
    strip: P = exp(S scale - LSE) over the visible keys, dV = P^T dO, dS =
    P (dO V^T - delta) scale, dQ += dS K, dK = dS^T Q, with delta =
    rowsum(dO O), all in f32."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    bk = min(bk, sk)
    dev = q.device
    q32, k32, v32 = q.float(), _pad_to(k, bk, -2).float(), \
        _pad_to(v, bk, -2).float()
    g32 = dout.float()
    delta = (g32 * o.float()).sum(-1)
    lse = lse.float()
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    ar = torch.arange(bk, device=dev)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for jb in range(k32.shape[-2] // bk):
        kb = k32[..., jb * bk:(jb + 1) * bk, :]
        vb = v32[..., jb * bk:(jb + 1) * bk, :]
        kpos = jb * bk + ar[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.einsum("...qd,...kd->...qk", q32, kb) * scale
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dvs.append(torch.einsum("...qk,...qd->...kd", p, g32))
        dp = torch.einsum("...qd,...kd->...qk", g32, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("...qk,...kd->...qd", ds, kb)
        dks.append(torch.einsum("...qk,...qd->...kd", ds, q32))
    dk = torch.cat(dks, dim=-2)[..., :sk, :]
    dv = torch.cat(dvs, dim=-2)[..., :sk, :]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ARGS = ([_build.I, _build.I] + [_build.P] * 10
         + [_build.P] + [_build.I] * 7 + [_build.F, _build.P])


def _strides(t) -> list[int]:
    """(batch, position, head) element strides of a (B, heads, S, D)
    view."""
    return [t.stride(0), t.stride(2), t.stride(1)]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           scale: Optional[float] = None):
    """CUDA kernel.  q, o, dout: (B, H, Sq, D); k, v: (B, KVH, Sk, D) with
    KVH | H; any strides with a unit last axis (a bf16 view that TMA cannot
    read in place is copied); lse: (B, H, Sq) f32.
    Returns (dq (B, H, Sq, D), dk, dv (B, KVH, Sk, D)) in q's dtype, each a
    permuted view of a position-major buffer."""
    global launches
    _build.require_cuda(NAME, q, k, v, o, lse, dout)
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    dt = _build.dtype_code(q, k, v, o, dout)
    _build.head_dim_ok(d)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be float32 {(b, h, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, dout = (_build.inner_contiguous(t)
                        for t in (q, k, v, o, dout))
    if dt == 1:
        q, k, v, o, dout, _ = _build.aligned(dt, q, k, v, o, dout)
    lse = lse.contiguous()
    scale = scale if scale is not None else d ** -0.5
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kvh, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dqv, dkv, dvv = (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
                     dv.permute(0, 2, 1, 3))
    strides = torch.tensor(
        sum((_strides(t) for t in (q, k, v, o, dout, dqv, dkv, dvv)), []),
        dtype=torch.int64)
    fn = _build.bind(NAME, "fab_launch", _ARGS)
    code = fn(dt, d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(o), _build.ptr(dout), _build.ptr(dq),
              _build.ptr(dk), _build.ptr(dv), _build.ptr(lse),
              _build.ptr(delta), _build.P(strides.data_ptr()), b, kvh,
              h // kvh, sq, sk, int(bool(causal)), int(window or 0),
              float(scale), _build.stream_of(q))
    launches += 1
    _build.check(code, NAME)
    return dqv, dkv, dvv
