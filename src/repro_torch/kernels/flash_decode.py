"""Flash-decode: one-token attention over a length-masked KV arena.

Port of ``repro/kernels/flash_decode.py`` (``flash_decode``, the Pallas
kernel at :96).  Two versions of one function live here:

  * :func:`flash_decode_plain` — the blockwise online-softmax loop of the
    reference's ``ops._flash_decode_ref`` in plain PyTorch (the CPU path
    and the oracle the CUDA kernel is held against);
  * :func:`launch` — the hand-written CUDA kernel
    (``csrc/flash_decode.cu``), one launch: split-KV CTAs reading the (B,
    S, KVH, D) arena in place through strides, the last CTA of each (slot,
    KV head) row to arrive merging the row's partials in split order
    (arrival counters from :func:`counters`).

Both take the fused-dequant branch of the TPU kernel (``_fd_kernel``,
``scaled=True``, flash_decode.py:39-44,72-75): an int8 or fp8 arena with
its (B, S, KVH) f32 scales, each row widened and scaled before it enters
the products.  Both also take a donor table ``share_src`` / ``share_len``
(B,) (prefix sharing, the reference's composed share view,
``repro/models/transformer.py:495-530``): slot b reads its rows [0,
share_len[b]) from slot share_src[b] (K, V and the scales alike); an
unshared slot passes (b, 0).

``ops.flash_decode`` picks between them by the tensors' device.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import NEG_INF, _pad_to

NAME = "flash_decode"
SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
REPLACES = "src/repro/kernels/flash_decode.py:96"
SPLIT = 128          # keys per split CTA; must match fk::SPLIT
MAX_GROUP = 16

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0
#: the scaled ones among them (an int8 / fp8 arena with its scales)
launches_scaled = 0
#: the ones with a donor table (prefix sharing)
launches_donor = 0

#: {(device index, owner, rows): int32 arrival counters}; the owner is the
#: current stream's handle, or the name given to :func:`owned_counters`
_COUNTERS: dict[tuple[int, int | str, int], torch.Tensor] = {}
_OWNER: Optional[str] = None


def share_rows(own: torch.Tensor, arena: torch.Tensor,
               share_src: torch.Tensor, share_len: torch.Tensor):
    """``own`` (B, S, ...) with batch b's rows [0, share_len[b]) taken from
    ``arena[share_src[b]]`` (the reference's ``_share_view`` select, bit
    for bit: the select moves raw bits, so a NaN in the rows it replaces
    never reaches the result).  None for None."""
    if own is None:
        return None
    b, s = own.shape[:2]
    donor = arena.index_select(0, share_src.to(device=own.device,
                                               dtype=torch.int64))
    take = (torch.arange(s, device=own.device)[None, :]
            < share_len.to(device=own.device)[:, None])
    take = take.view(b, s, *[1] * (own.ndim - 2))
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        own.element_size()]
    return torch.where(take, donor.view(bits), own.view(bits)).view(
        own.dtype)


def flash_decode_plain(q, k, v, *, lengths, window=None, scale=None,
                       bk: int = 512, k_scale=None, v_scale=None,
                       share_src=None, share_len=None):
    """q: (B, KVH, G, hd); k/v: (B, S, KVH, hd); lengths: (B,) live rows.
    Strip-mined online softmax over ``bk``-row KV strips with the per-slot
    tail mask ``kpos < min(lengths, S)`` (and ``kpos >= lengths - window``).
    ``k_scale`` / ``v_scale`` (B, S, KVH): each strip is widened to f32
    and multiplied by its scale strip before the products, as the
    reference's ``_flash_decode_ref`` does (ops.py:254-300).
    ``share_src`` / ``share_len`` (B,): K, V and the scales composed per
    slot first (:func:`share_rows`), then the same loop."""
    if share_src is not None:
        k, v, k_scale, v_scale = (share_rows(t, t, share_src, share_len)
                                  for t in (k, v, k_scale, v_scale))
    b, s, kvh, hd = k.shape
    g = q.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    bk = min(bk, s)
    kp = _pad_to(k, bk, 1)
    vp = _pad_to(v, bk, 1)
    ksp, vsp = _scale_pads(k_scale, v_scale, bk)
    nkb = kp.shape[1] // bk
    dev = q.device
    q32 = q.float() * scale
    lengths = lengths.to(device=dev, dtype=torch.int64)
    m = torch.full((b, kvh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, hd), dtype=torch.float32, device=dev)
    ar = torch.arange(bk, device=dev)
    for jb in range(nkb):
        kb, vb = _widened(kp, vp, ksp, vsp, jb * bk, bk)
        kpos = jb * bk + ar[None, :]
        # kpos < s: a length past the arena (a parked slot) attends the
        # arena only, never the strip padding (the reference's ref path
        # attends the zero pad rows there; its output is discarded)
        mask = (kpos < lengths[:, None]) & (kpos < s)        # (B, bk)
        if window is not None:
            mask &= kpos >= (lengths - window)[:, None]
        mk = mask[:, None, None, :]
        sc = torch.einsum("bkgh,bskh->bkgs", q32, kb)
        sc = torch.where(mk, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", p, vb)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).to(q.dtype)


def _scale_pads(k_scale, v_scale, bk: int):
    """The scales zero-padded to whole ``bk``-row strips (None, None when
    the arena is not scaled)."""
    if k_scale is None:
        return None, None
    return _pad_to(k_scale, bk, 1), _pad_to(v_scale, bk, 1)


def _widened(kp, vp, ksp, vsp, j0: int, bk: int):
    """Rows [j0, j0 + bk) of K and V widened to f32, each row times its
    scale where the arena is scaled."""
    kb = kp[:, j0:j0 + bk].float()
    vb = vp[:, j0:j0 + bk].float()
    if ksp is not None:
        kb = kb * ksp[:, j0:j0 + bk, :, None]
        vb = vb * vsp[:, j0:j0 + bk, :, None]
    return kb, vb


def counters(device: torch.device, rows: int) -> torch.Tensor:
    """The kernel's arrival counters for the current stream of ``device``
    (or for the owner named by :func:`owned_counters`): int32, ``rows`` of
    them, one per (slot, KV head) row.  The buffer is zeroed once, when it
    is allocated, and the kernel's combining CTA sets its row's counter
    back to 0, so a call issues no memset.  It is state kept between calls,
    the price of merging in the same launch (0.0213 ms against 0.0240 ms
    for a separate combine launch at llama3.2-3b's decode shape, 4 slots x
    1121 rows, on an H100 80GB HBM3 at 700 W; ``chip_smoke.py`` phase 3b).
    Each (owner, rows) pair has its own buffer: two calls in flight at once
    on one buffer would mix their arrivals.

    A CUDA graph bakes the buffer's address in and replays on whatever
    stream its caller is on, so a stream cannot own a graph's buffer: the
    serving engine's ``DecodeGraph`` runs its warm-up step and its capture
    inside :func:`owned_counters` under a name of its own, and the eager
    warm-up allocates that graph's buffer here.  None may be allocated under
    capture (its zeros would be a captured memset, not a state), and none
    is ever freed, since a graph may hold its address."""
    stream = torch.cuda.current_stream(device)
    owner = stream.cuda_stream if _OWNER is None else _OWNER
    key = (stream.device_index, owner, rows)
    buf = _COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: arrival counters allocated under CUDA graph "
                "capture; run the step once outside capture first")
        buf = _COUNTERS[key] = torch.zeros(rows, dtype=torch.int32,
                                           device=device)
    return buf


@contextlib.contextmanager
def owned_counters(owner: str) -> Iterator[None]:
    """Within the block, :func:`counters` hands out ``owner``'s buffers
    instead of the current stream's: a captured graph's launches keep their
    own arrival counters, whichever stream replays the graph."""
    global _OWNER
    prev, _OWNER = _OWNER, owner
    try:
        yield
    finally:
        _OWNER = prev


def occupancy(dtype: torch.dtype, head_dim: int, group: int,
              kv_dtype: Optional[torch.dtype] = None) -> int:
    """CTAs of the kernel for (q dtype, head_dim, GQA group, arena dtype:
    q's by default) that one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    fn = _build.bind(NAME, "fd_occupancy", [_build.I] * 4
                     + [ctypes.POINTER(ctypes.c_int)])
    qt, kt = _build.type_codes(dtype, kv_dtype or dtype)
    code = fn(qt, kt, head_dim, group, ctypes.byref(blocks))
    _build.check(code, NAME)
    return blocks.value


_ARGS = ([_build.I] * 3 + [_build.P] * 8 + [_build.LL] * 13
         + [_build.I] * 4 + [_build.P] * 3 + [_build.I, _build.F, _build.I,
                                              _build.I, _build.P])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: Optional[torch.Tensor], *, window: Optional[int] = None,
           scale: Optional[float] = None,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None,
           share_src: Optional[torch.Tensor] = None,
           share_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA kernel.  q: (B, H, D); k/v: (B, S, KVH, D) (any strides with a
    unit last axis — an arena layer view is read in place); lengths: (B,)
    live rows per slot or None (all S); k_scale / v_scale: (B, S, KVH) f32
    for an int8 / fp8 arena (read in place by strides), None otherwise;
    share_src / share_len: the donor table, (B,) int on the device (slot b
    reads rows [0, share_len[b]) of slot share_src[b], kept in [0, B) by
    the caller: the kernel reads the table on the device, unchecked), or
    None.  Returns (B, H, D) in q's dtype."""
    global launches, launches_scaled, launches_donor
    _build.require_cuda(NAME, q, k, v, lengths, k_scale, v_scale, share_src,
                        share_len)
    b, h, d = q.shape
    _, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    g = h // kvh
    if g > MAX_GROUP:
        raise ValueError(f"GQA group {g} > {MAX_GROUP} not instantiated")
    qt, kt = _build.kv_codes(q, k, v)
    _build.head_dim_ok(d)
    scaled = _build.scales(k, k_scale, v_scale)
    q, k, v, vec = _build.arena_aligned(
        qt, kt, *(_build.inner_contiguous(t) for t in (q, k, v)))
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    share_src, share_len = _build.donor_table(NAME, b, share_src, share_len)
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    nsplit = -(-s // SPLIT)
    part = torch.empty(b * kvh * nsplit * g * (d + 2), dtype=torch.float32,
                       device=q.device)
    count = counters(q.device, b * kvh)
    fn = _build.bind(NAME, "fd_launch", _ARGS)
    code = fn(qt, kt, d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(k_scale), _build.ptr(v_scale),
              _build.ptr(o), _build.ptr(part), _build.ptr(count),
              q.stride(0), q.stride(1),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              *_build.scale_strides(k_scale),
              o.stride(0), o.stride(1),
              b, kvh, g, s, _build.ptr(lengths), _build.ptr(share_src),
              _build.ptr(share_len), int(window or 0),
              float(scale), nsplit, vec, _build.stream_of(q))
    launches += 1
    launches_scaled += scaled
    launches_donor += share_src is not None
    _build.check(code, NAME)
    return o
