"""Public kernel API: dispatch by device + tail padding.

Port of ``repro/kernels/ops.py`` for the kernels of the serving path, with
the reference's argument layouts:

  * :func:`attention` — (..., S, D) forward attention (ops.py:194);
  * :func:`flash_decode` — (B, H, hd) queries over a (B, S, KVH, hd) cache
    with per-slot ``lengths`` (ops.py:324);
  * :func:`flash_prefill_chunk` — (B, C, H, hd) chunk queries over the
    arena with a runtime ``prefix`` (ops.py:450);
  * :func:`ssd` — the Mamba2 SSD chunked scan (ops.py:555), and
    :func:`ssd_decode_step`, its one-token recurrence (ops.py:578; plain
    PyTorch on every device, as the reference leaves it to XLA);

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
from repro_torch.kernels import flash_decode as _fd  # noqa: E402
from repro_torch.kernels import flash_prefill_chunk as _fpc  # noqa: E402
from repro_torch.kernels import ssd as _ssd  # noqa: E402
from repro_torch.kernels import matmul as _mm  # noqa: E402
from repro_torch.kernels import dotp as _dp  # noqa: E402
from repro_torch.kernels import conv2d as _cv  # noqa: E402

KERNEL_MODULES = (_fa, _fd, _fpc, _ssd, _mm, _dp, _cv)


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {m.NAME: m.launches for m in KERNEL_MODULES}


def reset_launch_counts() -> None:
    for m in KERNEL_MODULES:
        m.launches = 0


def _on_cuda(*ts) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in ts if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on unsupported/mixed devices: {kinds}")


def _no_scales(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV formats (k_scale/v_scale) are not ported yet "
            "(ROADMAP Open items 1.7.4)")


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


def _attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                     bq=256, bk=512):
    del bq
    k, v = _expand_gqa(q, k, v)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, bk=bk)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, bq: int = 256,
              bk: int = 512) -> torch.Tensor:
    """Multi-head attention over (..., S, D) tensors.

    As in the reference, the leading dims are batch/head and GQA may be
    pre-expanded; in addition the head axis (-3) of k/v may hold KVH heads
    dividing q's H, which the kernel reads in place (head h -> h // G).
    """
    if not _on_cuda(q, k, v):
        return _attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale, bq=bq, bk=bk)
    lead = q.shape[:-2]
    if q.ndim == 3:
        q4, k4, v4 = q[None], k[None], v[None]
    elif q.ndim == 4:
        q4, k4, v4 = q, k, v
    else:
        fold = lambda t: t.reshape(-1, *t.shape[-3:])
        q4, k4, v4 = fold(q), fold(k), fold(v)
    out = _fa.launch(q4, k4, v4, causal=causal, window=window, scale=scale)
    return out.reshape(*lead, *out.shape[-2:])


# ---------------------------------------------------------------------------
# flash-decode (serving decode step; per-slot length masking)
# ---------------------------------------------------------------------------

def _flash_decode_plain(q, k, v, *, lengths=None, window=None, scale=None,
                        bk=512, k_scale=None, v_scale=None):
    _no_scales(k_scale, v_scale)
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    qg = q.reshape(b, kvh, h // kvh, hd)
    out = _fd.flash_decode_plain(qg, k, v, lengths=lengths, window=window,
                                 scale=scale, bk=bk)
    return out.reshape(b, h, hd)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 lengths: Optional[torch.Tensor] = None,
                 window: Optional[int] = None,
                 scale: Optional[float] = None, bk: int = 512,
                 k_scale=None, v_scale=None) -> torch.Tensor:
    """One-token decode attention with per-sequence length masking.

    q: (B, H, hd); k/v: (B, S, KVH, hd); lengths: (B,) live KV rows per
    sequence (None = all S).  Returns (B, H, hd).  Lengths past S (a
    parked slot) attend all S rows and never read beyond them.
    """
    if not _on_cuda(q, k, v, lengths):
        return _flash_decode_plain(q, k, v, lengths=lengths, window=window,
                                   scale=scale, bk=bk, k_scale=k_scale,
                                   v_scale=v_scale)
    _no_scales(k_scale, v_scale)
    return _fd.launch(q, k, v, lengths, window=window, scale=scale)


# ---------------------------------------------------------------------------
# flash-prefill-chunk (chunked prompt ingestion; dynamic causal boundary)
# ---------------------------------------------------------------------------

def _flash_prefill_chunk_plain(q, k, v, *, prefix, window=None, scale=None,
                               bk=512, k_scale=None, v_scale=None):
    _no_scales(k_scale, v_scale)
    b, c, h, hd = q.shape
    _, s, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"n_heads={h} not divisible by kv_heads={kvh}")
    g = h // kvh
    # (B, C, H, hd) -> (B, KVH, G, C, hd): consecutive G heads share a KV head
    qg = q.transpose(1, 2).reshape(b, kvh, g, c, hd)
    out = _fpc.flash_prefill_chunk_plain(qg, k, v, prefix=prefix,
                                         window=window, scale=scale, bk=bk)
    return out.reshape(b, h, c, hd).transpose(1, 2)


def flash_prefill_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, prefix: torch.Tensor,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, bk: int = 512,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """Chunk-append prefill attention with a runtime causal boundary.

    q: (B, C, H, hd); k/v: (B, S, KVH, hd) with the chunk's K/V already at
    rows [prefix, prefix + C); prefix: (B,) rows live before the chunk.
    Returns (B, C, H, hd).
    """
    if not _on_cuda(q, k, v, prefix):
        return _flash_prefill_chunk_plain(q, k, v, prefix=prefix,
                                          window=window, scale=scale, bk=bk,
                                          k_scale=k_scale, v_scale=v_scale)
    _no_scales(k_scale, v_scale)
    return _fpc.launch(q, k, v, prefix, window=window, scale=scale)


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------

def _ssd_plain(x, log_a, B, C, *, chunk=256, initial_state=None):
    bh, nb = x.shape[0], B.shape[0]
    if nb != bh:
        if nb < 1 or bh % nb:
            raise ValueError(f"ssd: {nb} B/C rows do not divide {bh} rows")
        B = B.repeat_interleave(bh // nb, dim=0)
        C = C.repeat_interleave(bh // nb, dim=0)
    return _ssd.ssd_plain(x, log_a, B, C, chunk=chunk,
                          initial_state=initial_state)


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
    version's chunk; the kernel's inner chunk is its own (64 tokens): the
    result differs only by f32 rounding.
    """
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
