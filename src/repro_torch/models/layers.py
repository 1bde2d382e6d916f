"""Shared transformer layers: norms, RoPE, GQA attention, MLPs.

Port of ``repro/models/layers.py``: parameters are nested dicts of tensors,
every layer is ``fn(params, cfg, x, ...) -> y``, matmuls accumulate in f32
and cast back to the activation dtype (``_dot``).  Differences from the
reference, all forced by PyTorch being eager and mutable:

  * the serving attention layers write their new K/V rows straight into the
    resident arena view they are given (in place), then attend it; the
    reference patches a temporary copy and leaves the write to one scatter
    after its layer scan.
    The rows attended are the same.
  * XLA drops out-of-bounds scatter rows; torch raises (CPU) or
    device-asserts (CUDA).  Row writes are therefore masked to
    ``pos < max_seq`` explicitly, which is what keeps a parked slot
    (``pos = PARKED_POS``) from touching the arena.
  * the attention ops come from a ``kops`` namespace argument: the
    dispatching :mod:`repro_torch.kernels.ops` on the serving path, or
    ``ops.PLAIN`` for an all-plain oracle model.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import kv_format as kvf
from repro_torch.core import prng
from repro_torch.kernels import ops

# Decode-position sentinel for a slot whose prompt is mid-chunked-prefill
# (reference layers.py:31): the engine parks the slot's position here, so
# the decode step's row write for it is masked off (pos >= max_seq).
PARKED_POS: int = 1 << 30


def _dot(x: torch.Tensor, w: torch.Tensor, adtype) -> torch.Tensor:
    """x @ w accumulated in f32 (a bf16 GEMM accumulates in f32 and rounds
    its output once), cast to ``adtype``."""
    return torch.matmul(x, w).to(adtype)


# ---------------------------------------------------------------------------
# norms / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 mean and variance, one cast back (reference
    layers.py:130)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32 sinusoidal positions, sines in the even columns and
    cosines in the odd ones (reference layers.py:676)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : d // 2])
    return pe


_FREQS: dict = {}


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-arange(half) / half) in f32, made once per device (the
    decode step calls rope twice per layer; building it each time costs a
    host-to-device copy that stalls the dispatch queue)."""
    key = (half, float(theta), str(device))
    f = _FREQS.get(key)
    if f is None:
        exps = -torch.arange(0, half, dtype=torch.float32, device=device)
        f = _FREQS[key] = torch.pow(float(theta), exps / half)
    return f


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split RoPE with f32 angles.  x: (..., S, H, hd), positions:
    broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk_norm / sliding window)
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    adt = cfg.adtype
    q = _dot(x, p["wq"], adt).reshape(b, s, nh, hd)
    k = _dot(x, p["wk"], adt).reshape(b, s, nkv, hd)
    v = _dot(x, p["wv"], adt).reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.rms_eps)
        k = rmsnorm(p["k_norm"], k, cfg.rms_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: dict, cfg, x: torch.Tensor, *, positions,
              causal: bool = True, window: Optional[int] = None, kv=None,
              kops=ops) -> torch.Tensor:
    """Full-sequence attention with no cache (reference layers.py:198),
    the training forward.  x: (B, S, d); ``positions``: (B, S) for RoPE,
    or None (no RoPE: the encdec family); ``kv``: precomputed (k, v) (B,
    Sk, KVH, hd), the cross-attention's, or None to project them from x.
    K/V keep their KVH heads: the kernels read query head h's KV head as
    h // G where the reference repeats them (:228-229).  Returns (B, S,
    d)."""
    b, s, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q = _dot(x, p["wq"], cfg.adtype).reshape(b, s, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q, cfg.rms_eps)
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
        k, v = kv
    o = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal, window=window)
    return _dot(o.transpose(1, 2).reshape(b, s, -1), p["wo"], cfg.adtype)


def _decode_qkv(p, cfg, x_t, pos, use_rope: bool = True):
    """x_t: (B, d).  Returns q (B, 1, H, hd), k_t/v_t (B, 1, KVH, hd)."""
    b, _ = x_t.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    adt = cfg.adtype
    q = _dot(x_t, p["wq"], adt).reshape(b, 1, nh, hd)
    k_t = _dot(x_t, p["wk"], adt).reshape(b, 1, nkv, hd)
    v_t = _dot(x_t, p["wv"], adt).reshape(b, 1, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.rms_eps)
        k_t = rmsnorm(p["k_norm"], k_t, cfg.rms_eps)
    if use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_t = rope(k_t, pos[:, None], cfg.rope_theta)
    return q, k_t, v_t


def write_rows(arena: torch.Tensor, rows: torch.Tensor,
               pos: torch.Tensor) -> None:
    """arena[b, pos[b]] = rows[b] in place, for the b with pos[b] < S.

    arena: (B, S, ...) (K/V rows (B, S, KVH, hd), or their scales (B, S,
    KVH)); rows: (B, ...); pos: (B,).  A row whose pos is out of range (a
    parked slot) is left untouched — the reference gets this from XLA's
    drop-on-out-of-bounds scatter.  No host sync.
    """
    b, s = arena.shape[:2]
    ok = pos < s
    idx = torch.where(ok, pos, torch.zeros_like(pos)).long()
    bidx = torch.arange(b, device=arena.device)
    keep = arena[bidx, idx]
    arena[bidx, idx] = torch.where(ok.view(b, *[1] * (rows.ndim - 1)),
                                   rows.to(arena.dtype), keep)


def _quantized(view: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """New K/V rows in the view's storage format: {"k", "v"} (and
    {"k_scale", "v_scale"} for a scaled format), quantized once, as the
    reference quantizes on write (layers.py:330-338)."""
    if "k_scale" not in view:
        return {"k": k.to(view["k"].dtype), "v": v.to(view["v"].dtype)}
    # K and V quantized as one tensor: the same values, half the small
    # kernels in a decode step
    q, scale = kvf.quantize(kvf.get(kv_cache_format(view)),
                            torch.stack((k, v)))
    return {"k": q[0], "v": q[1], "k_scale": scale[0], "v_scale": scale[1]}


def _scales(view: dict) -> dict:
    """The kernels' scale arguments of a view (none for unscaled)."""
    return {"k_scale": view.get("k_scale"), "v_scale": view.get("v_scale")}


def write_chunk_rows(arena: torch.Tensor, rows: torch.Tensor,
                     slot: torch.Tensor, start: torch.Tensor) -> None:
    """arena[slot, start + j] = rows[j] in place, for the j with start + j
    < S: the chunk counterpart of :func:`write_rows`, with ``slot`` and
    ``start`` 0-d int64 device tensors (the captured chunk step reads them
    as data).

    arena: one layer's (N, S, ...) leaf (K/V rows (N, S, KVH, hd), or their
    scales (N, S, KVH)); rows: (C, ...) with C <= S.  Row j goes to row
    (start + j) mod S of the slot, keeping the old value where start + j >=
    S: C consecutive rows mod S are distinct, so no two writes meet, and a
    chunk at start = ``PARKED_POS`` (the captured step's warm-up) writes
    every row back unchanged; the reference drops those rows with its
    out-of-bounds scatter.  No host read, no boolean-mask index.
    """
    n, s = arena.shape[:2]
    c = rows.shape[0]
    if c > s:
        raise ValueError(f"a chunk of {c} rows does not fit {s} arena rows")
    pos = start + torch.arange(c, device=arena.device)
    flat = arena.view(n * s, *arena.shape[2:])     # raises unless a view
    idx = slot * s + pos % s
    keep = flat.index_select(0, idx)
    ok = (pos < s).view(c, *[1] * (rows.ndim - 1))
    # index_put_, not index_copy_: the latter has no fp8 kernel on the CPU
    flat.index_put_((idx,), torch.where(ok, rows.to(arena.dtype), keep))


def _donor(share, n: int) -> dict:
    """The kernels' donor-table arguments of ``share`` ((src, len) device
    tensors, each ``n`` entries), none for None."""
    if share is None:
        return {}
    return {"share_src": share[0].reshape(n), "share_len": share[1].reshape(n)}


def attention_chunk(p: dict, cfg, x: torch.Tensor, layer_kv: dict,
                    slot: torch.Tensor, positions: torch.Tensor,
                    start: torch.Tensor, prefix: torch.Tensor, *,
                    window: Optional[int] = None, kops=ops,
                    share=None) -> torch.Tensor:
    """One prompt chunk: write its K/V rows (quantized to the arena's
    format, with their scales) into arena slot ``slot`` at rows [start,
    start + C) (rows past max_seq dropped, :func:`write_chunk_rows`), then
    attend the slot's prefix + the chunk with ``flash_prefill_chunk`` over
    the stored rows, reading the slot through its slot table.

    x: (1, C, d); ``layer_kv``: one layer's arena {"k", "v"} (N, Smax, KVH,
    hd) (+ {"k_scale", "v_scale"} (N, Smax, KVH) for a scaled format);
    ``slot`` / ``start``: 0-d int64 device tensors; ``prefix``: (1,) int32
    holding ``start``.  ``share``: (share_src, share_len) 0-d device
    tensors or None: the slot reads its rows [0, share_len) from arena
    slot share_src (a fork reads its donor's prefix in place; reference
    ``_share_slot_view``, transformer.py:532); the chunk's writes go to
    its own slot at rows >= start >= share_len.
    """
    b, c, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    for key, rows in _quantized(layer_kv, k, v).items():
        write_chunk_rows(layer_kv[key], rows[0], slot, start)
    o = kops.flash_prefill_chunk(q, layer_kv["k"], layer_kv["v"],
                                 prefix=prefix, window=window,
                                 slots=slot.view(1), **_scales(layer_kv),
                                 **_donor(share, 1))
    return _dot(o.reshape(b, c, -1), p["wo"], cfg.adtype)


def attention_decode_rows(p: dict, cfg, x_t: torch.Tensor, layer_kv: dict,
                          pos: torch.Tensor, *,
                          window: Optional[int] = None,
                          kops=ops, share=None,
                          use_rope: bool = True) -> torch.Tensor:
    """One decode step: write the token's K/V row (quantized to the
    arena's format, with its scales) at ``pos`` into the arena layer view
    (masked to pos < max_seq), then ``flash_decode`` over it with
    ``lengths = pos + 1``; ``use_rope=False`` for a model with learned
    positions (the encdec decoder).  x_t: (B, d); layer_kv: {"k", "v"} of
    (B, Smax, KVH, hd) (+ scales (B, Smax, KVH)).  ``share``: (share_src, share_len)
    (B,) device tensors or None: slot b reads rows [0, share_len[b]) from
    slot share_src[b] (reference ``_share_view``, transformer.py:495); the
    row write still targets slot b's own row.  Returns (B, d)."""
    b, _ = x_t.shape
    q, k_t, v_t = _decode_qkv(p, cfg, x_t, pos, use_rope)
    for key, rows in _quantized(layer_kv, k_t[:, 0], v_t[:, 0]).items():
        write_rows(layer_kv[key], rows, pos)
    o = kops.flash_decode(q[:, 0], layer_kv["k"], layer_kv["v"],
                          lengths=pos + 1, window=window,
                          **_scales(layer_kv), **_donor(share, b))
    return _dot(o.reshape(b, cfg.n_heads * cfg.hd), p["wo"], cfg.adtype)


def init_kv_cache(cfg, batch: int, max_seq: int, *, device,
                  kv_format: str = "fp32",
                  n_layers: Optional[int] = None) -> dict:
    """KV cache {"k", "v"} of (batch, max_seq, KVH, hd) in ``kv_format``'s
    storage dtype (``fp32``: ``cfg.adtype``, so bf16 at a bf16 config, as
    the reference's fp32 format), with a leading (n_layers,) axis when
    given.  A scaled format (int8, fp8) adds ``k_scale`` / ``v_scale`` of
    (batch, max_seq, KVH) f32 filled with 1.0, so a row never written
    dequantizes to exact zeros (reference layers.py:408-431)."""
    fmt = kvf.get(kv_format)
    lead = (batch, max_seq) if n_layers is None else (n_layers, batch,
                                                      max_seq)
    shape = (*lead, cfg.n_kv_heads, cfg.hd)
    dt = fmt.resolve_dtype(cfg.adtype)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if fmt.scaled:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.ones((*lead, cfg.n_kv_heads),
                                    dtype=kvf.SCALE_DTYPE, device=device)
    return cache


def kv_cache_format(cache: dict) -> str:
    """The storage format of a (per-layer or stacked) KV cache, read from
    its leaves (reference layers.py:434): scales and an int8 arena are
    ``int8``, scales otherwise ``fp8``; a bf16 arena ``bf16``."""
    k = cache["k"]
    if "k_scale" in cache:
        return "int8" if k.dtype == torch.int8 else "fp8"
    if k.dtype == torch.bfloat16:
        return "bf16"
    return "fp32"


# ---------------------------------------------------------------------------
# MLPs / embeddings
# ---------------------------------------------------------------------------

def mlp(p: dict, cfg, x: torch.Tensor, *,
        act: Optional[str] = None) -> torch.Tensor:
    act = act or cfg.act
    adt = cfg.adtype
    up = _dot(x, p["w_up"], adt)
    if act == "silu_gated":
        gate = _dot(x, p["w_gate"], adt)
        h = F.silu(gate.float()).to(adt) * up
    elif act == "relu2":
        r = torch.relu(up.float())
        h = (r * r).to(adt)
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(adt)
    else:
        raise ValueError(f"unknown act {act!r}")
    return _dot(h, p["w_down"], adt)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    """Same distribution as the reference (layers.py:491)."""
    return _normal(gen, (vocab, d), d ** -0.5, dtype, device)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (any shape), through ``F.embedding``,
    whose backward on the card sums each row's gradient in a fixed order
    (``table[tokens]``'s accumulates with atomics, which a bit-for-bit
    restart cannot have)."""
    return F.embedding(tokens.long(), table)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

class _HeadF32(torch.autograd.Function):
    """x (N, d) @ w (d, V) -> f32 logits for bf16 operands on the card (the
    reference's ``preferred_element_type=f32``, layers.py:549) through the
    f32-out bf16 GEMM, which does not upcast the head; the backward takes
    the f32 cotangent at the operands' dtype, as a bf16 GEMM's is."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return g @ w.t(), x.t() @ g


def head_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, V) -> f32 logits, with a gradient: f32 operands
    multiply in f32, bf16 ones on the card through :class:`_HeadF32`, on
    the CPU upcast."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cpu":
        return x.float() @ w.float()
    lead = x.shape[:-1]
    return _HeadF32.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, w.shape[-1])


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """lse(logits) - logits[label] per token, f32 (B, S)."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v).float(),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE (reference layers.py:506): logits (B, S, V) f32,
    labels (B, S) int; with ``mask`` the masked mean, its count at least
    1."""
    nll = _token_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _block_nll_sum(x, labels, mask, w_head):
    return (_token_nll(head_f32(x, w_head), labels) * mask).sum()


def blockwise_cross_entropy(w_head: torch.Tensor, x: torch.Tensor,
                            labels: torch.Tensor,
                            mask: Optional[torch.Tensor] = None, *,
                            block: int = 512) -> torch.Tensor:
    """CE fused with the LM head over ``block``-row sequence blocks
    (reference layers.py:518): each block's f32 logits (B, block, V) chain
    into their logsumexp, the masked sums add up block by block in f32,
    and the mean divides by the mask's count (at least 1).  Under autograd
    each block is a ``torch.utils.checkpoint``: its logits are recomputed
    in the backward, so the (B, S, V) logits never exist at once.  The
    reference zero-pads S to whole blocks; the last block here is ragged
    instead, which adds the same masked-out zeros."""
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.float()
    nll_sum = x.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or w_head.requires_grad)
    for i in range(0, s, block):
        args = (x[:, i:i + block], labels[:, i:i + block],
                mask[:, i:i + block], w_head)
        part = (torch.utils.checkpoint.checkpoint(
                    _block_nll_sum, *args, use_reentrant=False)
                if grad else _block_nll_sum(*args))
        nll_sum = nll_sum + part
    return nll_sum / torch.clamp(mask.sum(), min=1.0)


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: row b of ``logits`` (B, V) holds no NaN or Inf (the
    serving engine's per-slot finite flag, reference engine.py:212)."""
    return torch.isfinite(logits).all(dim=-1)


# ---------------------------------------------------------------------------
# stochastic sampling (temperature / top-k / top-p / min-p)
# ---------------------------------------------------------------------------
#
# Reference layers.py:559-676.  A slot's key for the token at absolute
# cache position q is fold_in(fold_in(PRNGKey(0), seed), q): a pure function
# of the request's seed and q, so a stream does not depend on its
# batch-mates, on chunking or on preemption.  Everything here is made of
# ops whose result is defined bit for bit (IEEE adds, compares, integer
# arithmetic, a sort) but for three float64 logs rounded to float32 (equal
# on every device but for a double rounding), so the CPU and the card draw
# the same tokens.

_M32 = 0xFFFFFFFF

#: window of the float32 sums below (XLA's CPU tree reduction, see tree_sum)
SUM_WINDOW = 32
#: thresholds tried at once per round of the top-p search
TOP_P_WAYS = 15


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection float32 -> uint32, held in int64 (the sign
    bit of non-negatives flipped, all bits of negatives).  Callers
    canonicalise -0.0 to +0.0 first (``x + 0.0``)."""
    u = x.view(torch.int32).to(torch.int64) & _M32
    return torch.where(u < (1 << 31), u | (1 << 31), _M32 - u)


def _seq_sum(a: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, left to right."""
    acc = a[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _windowed(a: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., SUM_WINDOW, ceil(n / SUM_WINDOW)): ``a`` zero-padded
    evenly on both sides (the odd one on the right) to whole windows, term j
    of every window contiguous (so each add of ``_window_sums`` reads
    contiguous rows)."""
    pad = -a.shape[-1] % SUM_WINDOW
    if pad:
        a = F.pad(a, (pad // 2, pad - pad // 2))
    return a.unflatten(-1, (-1, SUM_WINDOW)).transpose(-1, -2).contiguous()


def _window_sums(w: torch.Tensor) -> torch.Tensor:
    """(..., SUM_WINDOW, m) -> (..., m): each window summed left to right."""
    acc = w[..., 0, :] + w[..., 1, :]
    for j in range(2, SUM_WINDOW):
        acc += w[..., j, :]
    return acc


def tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis of float32 ``a``, rounded as the reference's
    ``jnp.sum`` rounds them on XLA's CPU backend: while more than
    ``SUM_WINDOW`` terms are left, zero-pad them evenly on both sides (the
    odd one on the right) to whole windows and sum each window left to
    right; then sum what is left left to right.  The top-p cutoff compares
    such sums, and at top_p near 1 the terms they absorb decide which tail
    entries survive, so the order is part of the result."""
    while a.shape[-1] > SUM_WINDOW:
        a = _window_sums(_windowed(a))
    return _seq_sum(a)


def _top_p_cutoff(keys, w, order, pz):
    """Smallest key t with mass{x > t} < pz per row: the reference's 32
    bisection rounds over uint32 find the same t, since the mass (a
    ``tree_sum`` of the masked weights) only falls as t grows and changes
    only at the row's own keys.  Searches the sorted keys ``order`` instead,
    ``TOP_P_WAYS`` thresholds a round (ceil(log_16 V) rounds).  The answer
    lies in (lo, hi] of the sorted keys: the test fails below every key
    (all the mass is above; Z < top_p x Z never holds) and holds at the
    largest key (no mass above it)."""
    b, v = keys.shape
    dev = keys.device
    # the first level of tree_sum laid out once: a padding term has key 0
    # (above no threshold) and weight 0, as the reference's padding adds 0
    wide = v > SUM_WINDOW
    if wide:
        keys, w = _windowed(keys), _windowed(w)
    lo = torch.full((b, 1), -1, dtype=torch.int64, device=dev)
    hi = torch.full((b, 1), v - 1, dtype=torch.int64, device=dev)
    ways = TOP_P_WAYS
    r = torch.arange(1, ways + 1, dtype=torch.int64, device=dev)[None]
    width = v
    while width > 1:
        idx = torch.minimum(lo + ((hi - lo) * r + ways) // (ways + 1), hi)
        t = order.gather(1, idx)                               # (B, ways)
        t = t[:, :, None, None] if wide else t[:, :, None]
        above = torch.where(keys[:, None] > t, w[:, None], 0.0)
        mass = tree_sum(_window_sums(above) if wide else above)
        ok = mass < pz[:, None]
        hi = torch.minimum(torch.where(ok, idx, v).amin(-1, keepdim=True), hi)
        lo = torch.maximum(torch.where(ok, -1, idx).amax(-1, keepdim=True),
                           lo)
        width = -(-width // (ways + 1))
    return order.gather(1, hi)[:, 0]


def _f32(v: float) -> float:
    return float(np.float32(v))


# the float32 exp of XLA's CPU backend (jax 0.9.0): Cephes' expf, its
# multiply-adds fused; constants as XLA holds them
_EXP_LO, _EXP_HI = _f32(-87.8), _f32(88.8)
_LOG2E = _f32(1.442695)
_EXP_C1, _EXP_C2 = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 0.5))


_fma = prng.fma32


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as the reference computes it on XLA's CPU backend, op
    for op (its polynomial, fused multiply-adds, results below the smallest
    normal flushed to zero), so the same on every device.  XLA's exp is not
    correctly rounded, and the top-p sums at top_p = 1 keep or absorb tail
    weights by their last bit."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    m = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(m, -_EXP_C1, x)
    r = _fma(m, -_EXP_C2, r)
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = _fma(p, r, c)
    y = 1.0 + _fma(p, r * r, r)
    scale = ((m.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < prng.TINY_F32, 0.0, out)


def masked_logits(logits: torch.Tensor, temp: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale and mask logits per slot (reference layers.py:580).

    logits (B, V); temp / top_p / min_p (B,) float; top_k (B,) int.  Divide
    by the temperature, then keep the intersection of the top-k, nucleus
    and min-p sets of the scaled row; the rest becomes -inf.  top_k <= 0
    turns top-k off (ties at the k-th value all stay); an entry survives
    top-p iff the mass strictly above it is < top_p; min-p drops entries
    below min_p x the largest probability; the argmax always survives.  The
    three filters are value cutoffs on the monotone key, so the mask is one
    compare against their maximum.

    The cutoffs equal the reference's bisection results: top-k's is the
    k-th largest key (a sort), top-p's the smallest key whose mass above
    is < top_p x Z, found on the sorted keys (``_top_p_cutoff``) with the
    reference's float32 sums in the reference's order (``tree_sum``) over
    the reference's float32 weights (``xla_exp``); the min-p ``log`` is
    XLA's float32 log (``prng.xla_log``).
    """
    v = logits.shape[-1]
    x = logits.float() / torch.clamp(temp.float(), min=1e-6)[:, None]
    x = x + 0.0                          # -0.0 -> +0.0 for the key map
    keys = _monotone_key(x)
    top = x.amax(dim=-1, keepdim=True)
    w = xla_exp(x - top)                 # unnormalised probs
    pz = top_p.float() * tree_sum(w)
    order = torch.sort(keys, dim=-1).values
    k = torch.clamp(top_k.to(torch.int64), 1, v)
    ck = order.gather(1, (v - k)[:, None])[:, 0]  # k-th largest key
    ck = torch.where(top_k > 0, ck, 0)
    cp = _top_p_cutoff(keys, w, order, pz)
    # min-p in logit space: prob >= min_p x max-prob <=> x >= top +
    # log(min_p) (log 0 = -inf keeps everything when min-p is off)
    cm = _monotone_key(
        (top + prng.xla_log(min_p)[:, None]) + 0.0)[:, 0]
    cutoff = torch.maximum(torch.maximum(ck, cp), cm)
    cutoff = torch.minimum(cutoff, order[:, -1])     # the argmax survives
    return torch.where(keys >= cutoff[:, None], x, float("-inf"))


def sample_step(logits: torch.Tensor, seed: torch.Tensor, q: torch.Tensor,
                temp: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                min_p: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling (reference layers.py:648): Gumbel-argmax over
    :func:`masked_logits` with slot b's key ``fold_in(fold_in(PRNGKey(0),
    seed[b]), q[b])``, q the cache position the token will occupy.  Rows
    with ``temp <= 0`` take the plain argmax of ``logits``, bit for bit.
    Ties go to the first index.  Makes no host read (the sampled decode
    graph captures it).  Returns (B,) int64 tokens."""
    greedy = torch.argmax(logits, dim=-1)
    x = masked_logits(logits, temp, top_k, top_p, min_p)
    key0 = torch.zeros(seed.shape + (2,), dtype=torch.int64,
                       device=logits.device)        # PRNGKey(0)
    keys = prng.fold_in(prng.fold_in(key0, seed), q)
    stoch = torch.argmax(x + prng.gumbel(keys, (x.shape[-1],)), dim=-1)
    return torch.where(temp > 0, stoch, greedy)
