"""Chunk-append prefill attention: one prompt chunk against the KV arena.

Port of ``repro/kernels/flash_prefill_chunk.py`` (``flash_prefill_chunk``,
the Pallas kernel at :97).  The chunk's own K/V rows are already written at
rows [prefix, prefix + C) of the arena; chunk query i sits at position
prefix + i and sees ``kpos <= prefix + i``.  ``prefix`` is runtime data.

  * :func:`flash_prefill_chunk_plain` — the reference's
    ``ops._flash_prefill_chunk_ref`` in plain PyTorch;
  * :func:`launch` — the CUDA kernel (``csrc/flash_prefill_chunk.cu``),
    which walks the keys in flash_decode's splits and merge order so chunk
    row j equals flash_decode at pos = prefix + j bit for bit.

Both take the fused-dequant branch of the TPU kernel (``_fpc_kernel``,
flash_prefill_chunk.py:38-44,73-76): an int8 or fp8 arena with its (B, S,
KVH) f32 scales, as flash_decode does.  Both also take a slot table
``slots`` (B,) over the whole arena (N, S, KVH, hd): query batch b reads
arena row ``slots[b]``, so a captured chunk step (the serving engine's
chunk graphs) reads its slot as device data, where the reference traces a
``dynamic_slice`` of the arena (transformer.py:588).  Beside it both take
a donor table ``share_src`` / ``share_len`` (B,) (prefix sharing): batch b
reads its rows [0, share_len[b]) from arena row ``share_src[b]``, the rest
from its own (``slots[b]``, or b), K, V and the scales alike, as the
reference's ``_share_slot_view`` (transformer.py:532-547) composes them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import _scale_pads, _widened, share_rows
from repro_torch.kernels.ops import NEG_INF, _pad_to

NAME = "flash_prefill_chunk"
SOURCE = "src/repro_torch/kernels/csrc/flash_prefill_chunk.cu"
REPLACES = "src/repro/kernels/flash_prefill_chunk.py:97"

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0
#: the scaled ones among them (an int8 / fp8 arena with its scales)
launches_scaled = 0
#: the ones with a donor table (prefix sharing)
launches_donor = 0
#: the ones made inside :func:`verify_pass` (a speculative verify)
launches_verify = 0
_verifying = False


@contextlib.contextmanager
def verify_pass():
    """Count the launches made inside also as ``launches_verify``
    (``LM.verify_chunk``: a speculative verify pass is a chunk step at k
    rows)."""
    global _verifying
    outer, _verifying = _verifying, True
    try:
        yield
    finally:
        _verifying = outer


def flash_prefill_chunk_plain(q, k, v, *, prefix, window=None, scale=None,
                              bk: int = 512, k_scale=None, v_scale=None,
                              slots=None, share_src=None, share_len=None):
    """q: (B, KVH, G, C, hd); k/v: (B, S, KVH, hd), or (N, S, KVH, hd)
    with ``slots`` (B,) naming each batch's arena row; prefix: (B,) rows
    live before the chunk.  Strip-mined online softmax; chunk row i attends
    ``kpos <= prefix + i`` (and ``> prefix + i - window``).  ``k_scale`` /
    ``v_scale`` (B or N, S, KVH): strips widened and scaled as the
    reference's ``_flash_prefill_chunk_ref`` does (ops.py:386-420).
    ``share_src`` / ``share_len`` (B,): after the ``slots`` gather, each
    batch's K, V and scales composed with its donor row's
    (:func:`flash_decode.share_rows`), then the same loop."""
    arena = (k, v, k_scale, v_scale)
    if slots is not None:
        rows = slots.to(device=k.device, dtype=torch.int64)
        k, v = k.index_select(0, rows), v.index_select(0, rows)
        if k_scale is not None:
            k_scale = k_scale.index_select(0, rows)
            v_scale = v_scale.index_select(0, rows)
    if share_src is not None:
        k, v, k_scale, v_scale = (
            share_rows(t, a, share_src, share_len)
            for t, a in zip((k, v, k_scale, v_scale), arena))
    b, s, kvh, hd = k.shape
    g, c = q.shape[2], q.shape[3]
    scale = scale if scale is not None else hd ** -0.5
    bk = min(bk, s)
    kp = _pad_to(k, bk, 1)
    vp = _pad_to(v, bk, 1)
    ksp, vsp = _scale_pads(k_scale, v_scale, bk)
    nkb = kp.shape[1] // bk
    dev = q.device
    q32 = q.float() * scale
    prefix = prefix.to(device=dev, dtype=torch.int64)
    qpos = prefix[:, None] + torch.arange(c, device=dev)[None, :]   # (B, C)
    m = torch.full((b, kvh, g, c), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, c), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, c, hd), dtype=torch.float32, device=dev)
    ar = torch.arange(bk, device=dev)
    for jb in range(nkb):
        kb, vb = _widened(kp, vp, ksp, vsp, jb * bk, bk)
        kpos = (jb * bk + ar)[None, None, :]                  # (1, 1, bk)
        mask = (kpos <= qpos[..., None]) & (kpos < s)        # (B, C, bk)
        if window is not None:
            mask &= kpos > (qpos[..., None] - window)
        mk = mask[:, None, None]
        sc = torch.einsum("bkgch,bskh->bkgcs", q32, kb)
        sc = torch.where(mk, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgcs,bskh->bkgch",
                                                    p, vb)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).to(q.dtype)


_ARGS = ([_build.I] * 3 + [_build.P] * 6 + [_build.LL] * 15
         + [_build.I] * 6 + [_build.P] * 4 + [_build.I, _build.F, _build.I,
                                              _build.P])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           prefix: torch.Tensor, *, window: Optional[int] = None,
           scale: Optional[float] = None,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None,
           slots: Optional[torch.Tensor] = None,
           share_src: Optional[torch.Tensor] = None,
           share_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA kernel.  q: (B, C, H, D); k/v: (B, S, KVH, D) read in place by
    strides, or the whole arena (N, S, KVH, D) with ``slots`` (B,) int on
    the device naming each batch's row (kept in [0, N) by the caller: the
    kernel reads them on the device, unchecked); prefix: (B,) int rows live
    before the chunk; k_scale / v_scale: (B or N, S, KVH) f32 for an int8 /
    fp8 arena, None otherwise; share_src / share_len: the donor table,
    (B,) int on the device (batch b reads rows [0, share_len[b]) of arena
    row share_src[b], kept in [0, N) by the caller, unchecked), or None.
    Returns (B, C, H, D) in q's dtype.

    With a slot table or a donor table the arena is read in place or not
    at all: an arena the kernel could only read through a copy
    (``_build.arena_aligned``: rows under 16 bytes) raises, as a copy would
    move every slot."""
    global launches, launches_scaled, launches_donor, launches_verify
    _build.require_cuda(NAME, q, k, v, prefix, k_scale, v_scale, slots,
                        share_src, share_len)
    b, c, h, d = q.shape
    na, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    if slots is None and na != b:
        raise ValueError(f"{na} arena rows for {b} query batches and no "
                         f"slot table")
    if slots is not None and tuple(slots.shape) != (b,):
        raise ValueError(f"slots {tuple(slots.shape)}, expected ({b},)")
    qt, kt = _build.kv_codes(q, k, v)
    _build.head_dim_ok(d)
    scaled = _build.scales(k, k_scale, v_scale)
    given = (k.data_ptr(), v.data_ptr())
    q, k, v, vec = _build.arena_aligned(
        qt, kt, *(_build.inner_contiguous(t) for t in (q, k, v)))
    if ((slots is not None or share_src is not None)
            and (k.data_ptr(), v.data_ptr()) != given):
        raise ValueError(f"{NAME}: a slot table reads the arena in place; "
                         f"this {tuple(k.shape)} {k.dtype} arena would be "
                         f"copied (rows under 16 bytes or not unit-stride)")
    prefix = prefix.to(device=q.device, dtype=torch.int32).contiguous()
    if slots is not None:
        slots = slots.to(device=q.device, dtype=torch.int32).contiguous()
    share_src, share_len = _build.donor_table(NAME, b, share_src, share_len)
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    fn = _build.bind(NAME, "fpc_launch", _ARGS)
    code = fn(qt, kt, d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(o),
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              *_build.scale_strides(k_scale),
              o.stride(0), o.stride(1), o.stride(2),
              b, na, kvh, h // kvh, c, s, _build.ptr(prefix),
              _build.ptr(slots), _build.ptr(share_src), _build.ptr(share_len),
              int(window or 0), float(scale), vec,
              _build.stream_of(q))
    launches += 1
    launches_scaled += scaled
    launches_donor += share_src is not None
    launches_verify += _verifying
    _build.check(code, NAME)
    return o
