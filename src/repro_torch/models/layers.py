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

import torch
import torch.nn.functional as F

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

    arena: (B, S, KVH, hd); rows: (B, KVH, hd); pos: (B,).  A row whose pos
    is out of range (a parked slot) is left untouched — the reference gets
    this from XLA's drop-on-out-of-bounds scatter.  No host sync.
    """
    b, s = arena.shape[:2]
    ok = pos < s
    idx = torch.where(ok, pos, torch.zeros_like(pos)).long()
    bidx = torch.arange(b, device=arena.device)
    keep = arena[bidx, idx]
    arena[bidx, idx] = torch.where(ok[:, None, None], rows.to(arena.dtype),
                                   keep)


def attention_chunk(p: dict, cfg, x: torch.Tensor, slot_kv: dict,
                    positions: torch.Tensor, start: int,
                    prefix: torch.Tensor, *, window: Optional[int] = None,
                    kops=ops) -> torch.Tensor:
    """One prompt chunk: write its K/V rows into the slot's arena view at
    rows [start, start + C) (rows past max_seq dropped), then attend the
    slot's prefix + the chunk with ``flash_prefill_chunk``.

    x: (B, C, d); ``slot_kv``: {"k", "v"} views (B, Smax, KVH, hd) of the
    resident arena; ``prefix``: (B,) int32 tensor holding ``start``.
    """
    b, c, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    ck, cv = slot_kv["k"], slot_kv["v"]
    n = max(0, min(c, ck.shape[1] - start))
    ck[:, start:start + n] = k[:, :n].to(ck.dtype)
    cv[:, start:start + n] = v[:, :n].to(cv.dtype)
    o = kops.flash_prefill_chunk(q, ck, cv, prefix=prefix, window=window)
    return _dot(o.reshape(b, c, -1), p["wo"], cfg.adtype)


def attention_decode_rows(p: dict, cfg, x_t: torch.Tensor, layer_kv: dict,
                          pos: torch.Tensor, *,
                          window: Optional[int] = None,
                          kops=ops) -> torch.Tensor:
    """One decode step: write the token's K/V row at ``pos`` into the
    arena layer view (masked to pos < max_seq), then ``flash_decode`` over
    it with ``lengths = pos + 1``.  x_t: (B, d); layer_kv: {"k", "v"} of
    (B, Smax, KVH, hd).  Returns (B, d)."""
    b, _ = x_t.shape
    q, k_t, v_t = _decode_qkv(p, cfg, x_t, pos, True)
    write_rows(layer_kv["k"], k_t[:, 0], pos)
    write_rows(layer_kv["v"], v_t[:, 0], pos)
    o = kops.flash_decode(q[:, 0], layer_kv["k"], layer_kv["v"],
                          lengths=pos + 1, window=window)
    return _dot(o.reshape(b, cfg.n_heads * cfg.hd), p["wo"], cfg.adtype)


def init_kv_cache(cfg, batch: int, max_seq: int, *, device,
                  kv_format: str = "fp32",
                  n_layers: Optional[int] = None) -> dict:
    """KV cache {"k", "v"} of (batch, max_seq, KVH, hd), with a leading
    (n_layers,) axis when given.  Only the ``fp32`` storage format is
    ported: it stores at ``cfg.adtype`` (so bf16 at a bf16 config),
    exactly as the reference's fp32 format (layers.py:418-421)."""
    if kv_format != "fp32":
        raise NotImplementedError(
            f"kv_format={kv_format!r} is not ported yet (ROADMAP Open "
            f"items 1.7.4); only 'fp32' is")
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    if n_layers is not None:
        shape = (n_layers, *shape)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


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
    return table[tokens]
