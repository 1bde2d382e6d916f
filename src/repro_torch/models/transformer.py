"""Decoder-only LM: dense layer functions + the serving drivers.

Port of ``repro/models/transformer.py`` for the dense family: the layer
functions (:55-101), ``attention_prefill`` (:169) and the ``LM`` driver
(:245) with ``init``, ``init_cache``, ``prefill``, ``prefill_chunk`` /
``_chunk_hidden`` and ``decode_step`` / ``_decode_rows``.

Parameters keep the reference's layout — per-layer tensors stacked on a
leading L axis, weights stored (in, out) and applied as ``x @ W`` — so a
JAX parameter pytree converts leaf by leaf (``models/convert.py``).  The
reference's ``lax.scan`` over layers is a Python loop over L here.  The KV
arena ``{"k", "v"}`` of (L, slots, max_seq, KVH, hd) is resident and
written in place: each layer writes its own rows into its arena slice and
then attends it, where the reference scans read-only views and scatters
once after the scan (under buffer donation).  Logits come out in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import device as device_mod
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# dense layer
# ---------------------------------------------------------------------------

def dense_layer_chunk(p, cfg, x, slot_kv, positions, start, prefix, *,
                      window=None, kops=ops):
    """One prompt chunk through a dense layer (reference :74)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + L.attention_chunk(p["attn"], cfg, h, slot_kv, positions, start,
                              prefix, window=window, kops=kops)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp(p["mlp"], cfg, h)


def dense_layer_decode_rows(p, cfg, x_t, layer_kv, pos, *, window=None,
                            kops=ops):
    """One decode step through a dense layer (reference :90)."""
    h = L.rmsnorm(p["ln1"], x_t, cfg.rms_eps)
    x_t = x_t + L.attention_decode_rows(p["attn"], cfg, h, layer_kv, pos,
                                        window=window, kops=kops)
    h = L.rmsnorm(p["ln2"], x_t, cfg.rms_eps)
    return x_t + L.mlp(p["mlp"], cfg, h)


def attention_prefill(p_attn, cfg, h, cache_kv, positions, *, window=None,
                      kops=ops):
    """Causal full-sequence attention + KV-cache fill (reference :169).

    h: (B, S, d); cache_kv: {"k", "v"} views (B, Smax, KVH, hd), rows
    [0, S) written in place.  K/V go to the attention op with their KVH
    heads; the kernel reads query head h's KV head as h // G instead of the
    reference's ``jnp.repeat``.
    """
    q, k, v = L._project_qkv(p_attn, cfg, h, positions)
    b, s = q.shape[:2]
    cache_kv["k"][:, :s] = k.to(cache_kv["k"].dtype)
    cache_kv["v"][:, :s] = v.to(cache_kv["v"].dtype)
    of = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window)
    o = of.transpose(1, 2).reshape(b, s, -1)
    return L._dot(o, p_attn["wo"], cfg.adtype)


def _prefill_layer(p, cfg, x, cache_kv, positions, *, window=None,
                   kops=ops):
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + attention_prefill(p["attn"], cfg, h, cache_kv, positions,
                              window=window, kops=kops)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp(p["mlp"], cfg, h)


def layer_params(stacked, i: int):
    """The i-th layer's parameter views of a stacked (L, ...) tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def head_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, d) @ (d, V) -> f32 logits (reference: ``preferred_element_type
    = f32``).  f32 operands multiply in f32.  On the card, bf16 operands go
    through the f32-out bf16 GEMM (``torch.mm(..., out_dtype=f32)``), which
    does not upcast the head (a 3072 x 128256 f32 copy per step at
    llama3.2-3b width); on the CPU they are upcast."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    if h.device.type == "cpu":
        return h.float() @ w.float()
    return torch.mm(h, w, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# LM driver
# ---------------------------------------------------------------------------

class LM:
    """Dense decoder-only LM: parameter init, arena init and the three
    serving drivers (monolithic prefill, chunked prefill, decode step).

    ``device``: where ``init``/``init_cache`` allocate ("cuda" unless the
    caller asks for "cpu"; a missing card raises).  ``kernels``: the
    attention-op namespace — :mod:`repro_torch.kernels.ops` (dispatch by
    device: the CUDA kernels on the card) or ``ops.PLAIN`` (the plain
    versions everywhere, the on-card oracle).
    """

    def __init__(self, cfg, *, device="cuda", kernels=ops):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported (ROADMAP Open items "
                f"1.8); only 'dense' is")
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.kops = kernels

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Random weights from an explicit ``torch.Generator`` seeded with
        ``seed``, with the reference's distributions: N(0, 1) scaled by
        fan-in^-1/2 for every projection (layers.py:160-174, :450-459),
        d^-1/2 for the embedding and head tables (:491), unit norms.  Made
        on ``self.device`` one layer-slice at a time."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        pd, d, nl = cfg.pdtype, cfg.d_model, cfg.n_layers

        def stacked(make):
            first = make()
            out = torch.empty((nl, *first.shape), dtype=first.dtype,
                              device=dev)
            out[0] = first
            for i in range(1, nl):
                out[i] = make()
            return out

        def ones(n):
            return torch.ones((nl, n), dtype=pd, device=dev)

        std_in, std_ff = d ** -0.5, cfg.d_ff ** -0.5
        std_o = (cfg.n_heads * cfg.hd) ** -0.5
        shapes = {"wq": ((d, cfg.n_heads * cfg.hd), std_in),
                  "wk": ((d, cfg.n_kv_heads * cfg.hd), std_in),
                  "wv": ((d, cfg.n_kv_heads * cfg.hd), std_in),
                  "wo": ((cfg.n_heads * cfg.hd, d), std_o)}
        attn = {name: stacked(lambda s=s, sd=sd: L._normal(gen, s, sd, pd,
                                                           dev))
                for name, (s, sd) in shapes.items()}
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": ones(cfg.hd)}
            attn["k_norm"] = {"scale": ones(cfg.hd)}
        shapes = {"w_up": ((d, cfg.d_ff), std_in),
                  "w_down": ((cfg.d_ff, d), std_ff)}
        if cfg.act == "silu_gated":
            shapes["w_gate"] = ((d, cfg.d_ff), std_in)
        mlp = {name: stacked(lambda s=s, sd=sd: L._normal(gen, s, sd, pd,
                                                          dev))
               for name, (s, sd) in shapes.items()}
        params = {
            "embed": L.embed_init(gen, cfg.vocab, d, pd, dev),
            "layers": {"ln1": {"scale": ones(d)}, "attn": attn,
                       "ln2": {"scale": ones(d)}, "mlp": mlp},
            "final_norm": {"scale": torch.ones(d, dtype=pd, device=dev)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.embed_init(gen, cfg.vocab, d, pd,
                                             dev).T.contiguous()
        return params

    def head(self, params) -> torch.Tensor:
        return params["lm_head"] if not self.cfg.tie_embeddings \
            else params["embed"].T

    # -- arena ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   kv_format: str = "fp32") -> dict:
        """Stacked per-layer caches {"k", "v"} of (L, batch, max_seq, KVH,
        hd) at the activation dtype (the fp32 storage format)."""
        return L.init_kv_cache(self.cfg, batch, max_seq, kv_format=kv_format,
                               device=self.device,
                               n_layers=self.cfg.n_layers)

    @staticmethod
    def _layer_view(cache, i: int, slot: Optional[int] = None) -> dict:
        if slot is None:
            return {key: leaf[i] for key, leaf in cache.items()}
        return {key: leaf[i, slot:slot + 1] for key, leaf in cache.items()}

    # -- drivers -------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                cache: dict) -> torch.Tensor:
        """Run the prompt, fill rows [0, S) of ``cache`` (a (L, B, Smax,
        ...) arena or a slot view of one) in place, return last-position
        logits (B, V) f32."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_lookup(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(cfg.n_layers):
            x = _prefill_layer(layer_params(params["layers"], i), cfg, x,
                               self._layer_view(cache, i), positions,
                               kops=self.kops)
        h = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        return head_logits(h[:, -1], self.head(params))

    def prefill_chunk(self, params, tokens: torch.Tensor, cache: dict,
                      slot: int, start: int, last_idx: int) -> torch.Tensor:
        """Ingest one prompt chunk into slot ``slot`` of the arena.

        tokens: (1, C); rows [start, start + C) of the slot are written in
        place (rows past max_seq dropped); returns the logits (1, V) f32 at
        the chunk's last real token ``last_idx``.  ``slot``/``start``/
        ``last_idx`` are host ints: the reference clamps a traced slot index
        (``_slot_view``); here an out-of-range slot is an error.
        """
        h = self._chunk_hidden(params, tokens, cache, slot, start)
        return head_logits(h[:, last_idx], self.head(params))

    def _chunk_hidden(self, params, tokens, cache, slot: int, start: int):
        cfg = self.cfg
        nslots = cache["k"].shape[1]
        if not (isinstance(slot, int) and 0 <= slot < nslots):
            raise ValueError(f"slot {slot!r} outside [0, {nslots})")
        b, c = tokens.shape
        x = L.embed_lookup(params["embed"], tokens)
        positions = (start + torch.arange(c, device=x.device))[None]
        positions = positions.expand(b, c)
        prefix = torch.full((b,), start, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            x = dense_layer_chunk(layer_params(params["layers"], i), cfg, x,
                                  self._layer_view(cache, i, slot),
                                  positions, start, prefix, kops=self.kops)
        return L.rmsnorm(params["final_norm"], x, cfg.rms_eps)

    def decode_step(self, params, token_t: torch.Tensor, cache: dict,
                    pos: torch.Tensor) -> torch.Tensor:
        """token_t: (B,) int; pos: (B,) row to write per slot.  Writes each
        layer's K/V row in place (parked slots, pos >= max_seq, untouched)
        and returns logits (B, V) f32."""
        cfg = self.cfg
        x_t = L.embed_lookup(params["embed"], token_t)
        x_t = self._decode_rows(params, cfg, x_t, cache, pos)
        h = L.rmsnorm(params["final_norm"], x_t, cfg.rms_eps)
        return head_logits(h, self.head(params))

    def _decode_rows(self, params, cfg, x_t, cache, pos):
        for i in range(cfg.n_layers):
            x_t = dense_layer_decode_rows(layer_params(params["layers"], i),
                                          cfg, x_t, self._layer_view(cache, i),
                                          pos, kops=self.kops)
        return x_t

