"""Whisper-style encoder-decoder backbone (conv frontend stubbed).

Port of ``repro/models/encdec.py``.  The caller hands over precomputed
frame embeddings (B, enc_seq, d): the two conv layers + GELU of the real
frontend are outside the backbone.  Encoder: bidirectional self-attention
and a GELU MLP under LayerNorm, sinusoidal positions.  Decoder: learned
absolute positions (no RoPE), causal self-attention, cross-attention over
the encoder output, a GELU MLP.  The cross K/V are computed once at
prefill and kept in the slot's arena for every decode step, so the
encoder never runs again.

:class:`EncDecLM` is not an ``LM`` (its arena and prefill differ), as in
the reference (:80); it gives the surface the serving engine uses:
``init_cache``, ``seq_axes``, ``num_slots``, ``slot_view``, ``prefill(...,
frames=)``, ``decode_step`` and the shared ``decode_and_sample``.  The
arena is flat: the decoder's self-attention rows ``{"k", "v"}`` (L, slots,
max_seq, KVH, hd) beside the cross K/V ``{"cross_k", "cross_v"}`` (L,
slots, enc_seq, KVH, hd), both at the activation dtype (the reference's
fp32 format, the only one this family serves).  The cross leaves have no
``max_seq`` axis: ``seq_axes`` reports them as per-slot state.

Attention goes through the kernels: the encoder and the cross-attention
prefill through ``flash_attention`` (non-causal; the kernel masks keys to
the true Sk, so Sk = 1500 needs no padding), the decoder's prompt through
it causally, the decode step's self-attention through ``flash_decode``
over the slot's rows and its cross-attention through ``flash_decode`` over
all enc_seq cross rows (``lengths=None``).  The reference runs the
decoder's prompt attention with its jnp path (:197) and, in its Pallas
mode, a non-causal call whose Sk is not a whole tile too (ops.py:236-246).
"""
from __future__ import annotations

import torch

from repro_torch.core import device as device_mod
from repro_torch.core import kv_format as kvf
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: the arena's cross-attention leaves (no sequence axis)
CROSS = ("cross_k", "cross_v")


def _stack_init(cfg, gen, dev, n: int, attn_names) -> dict:
    """One stack of ``n`` layers: LayerNorms (unit scale, zero bias), an
    attention block per name in ``attn_names`` with each a LayerNorm in
    front of it, and the GELU MLP; the reference's distributions
    (layers.py:160-174, :450-459)."""
    pd, d, hd = cfg.pdtype, cfg.d_model, cfg.hd
    nh, nkv = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, std):
        return T.stack_layers(n, lambda: L._normal(gen, shape, std, pd, dev),
                              dev)

    def ln():
        return {"scale": torch.ones((n, d), dtype=pd, device=dev),
                "bias": torch.zeros((n, d), dtype=pd, device=dev)}

    def attn():
        p = {"wq": normal((d, nh * hd), d ** -0.5),
             "wk": normal((d, nkv * hd), d ** -0.5),
             "wv": normal((d, nkv * hd), d ** -0.5),
             "wo": normal((nh * hd, d), (nh * hd) ** -0.5)}
        if cfg.qk_norm:
            for key in ("q_norm", "k_norm"):
                p[key] = {"scale": torch.ones((n, hd), dtype=pd, device=dev)}
        return p

    tree = {}
    for norm, name in attn_names:
        tree[norm] = ln()
        tree[name] = attn()
    tree["ln2"] = ln()
    tree["mlp"] = {"w_up": normal((d, cfg.d_ff), d ** -0.5),
                   "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}
    return tree


#: (norm, attention) of an encoder layer and of a decoder layer
ENC_BLOCKS = (("ln1", "attn"),)
DEC_BLOCKS = (("ln1", "self_attn"), ("ln_x", "cross_attn"))


def attention(p, cfg, x, *, causal: bool, kv=None, kops=ops):
    """Full-sequence attention without positions (reference
    ``layers.attention`` with ``positions=None``).  x: (B, S, d); ``kv``:
    precomputed (k, v) (B, Sk, KVH, hd), the cross-attention's, or None
    to project them from x.  Returns (B, S, d)."""
    return L.attention(p, cfg, x, positions=None, causal=causal, kv=kv,
                       kops=kops)


def enc_layer(p, cfg, x, *, kops=ops):
    """One encoder layer (reference :35)."""
    h = L.layernorm(p["ln1"], x, cfg.rms_eps)
    x = x + attention(p["attn"], cfg, h, causal=False, kops=kops)
    h = L.layernorm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp(p["mlp"], cfg, h, act="gelu")


def dec_train_layer(p, cfg, x, enc_out, *, kops=ops):
    """One decoder layer of the training forward (reference
    ``dec_layer_apply``, :68): causal self-attention over the whole
    sequence, cross-attention over this layer's K/V of ``enc_out``, the
    GELU MLP; no positions (learned absolute ones are added before)."""
    eps = cfg.rms_eps
    h = L.layernorm(p["ln1"], x, eps)
    x = x + attention(p["self_attn"], cfg, h, causal=True, kops=kops)
    h = L.layernorm(p["ln_x"], x, eps)
    x = x + attention(p["cross_attn"], cfg, h, causal=False,
                      kv=cross_kv(p, cfg, enc_out), kops=kops)
    h = L.layernorm(p["ln2"], x, eps)
    return x + L.mlp(p["mlp"], cfg, h, act="gelu")


def _no_aux(fn):
    """A layer function returning x, as a stack layer with no aux loss."""
    return lambda lp, x, i: (fn(lp, x), None)


def cross_kv(p, cfg, enc_out):
    """A decoder layer's cross-attention K/V from the encoder output
    (reference ``_cross_kv``, :56): (B, Se, KVH, hd) each."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.hd)
    return (L._dot(enc_out, p["cross_attn"]["wk"], cfg.adtype).reshape(shape),
            L._dot(enc_out, p["cross_attn"]["wv"], cfg.adtype).reshape(shape))


class EncDecLM:
    """Whisper-backbone driver: ``init``, ``encode``, ``prefill(...,
    frames=)``, ``decode_step``, ``decode_and_sample`` and the arena
    surface of the serving engine.

    ``device``: where ``init`` / ``init_cache`` allocate ("cuda" unless the
    caller asks for "cpu").  ``kernels``: :mod:`repro_torch.kernels.ops`
    or ``ops.PLAIN`` (the on-card oracle), as for ``LM``.
    """

    #: the reference's engine refuses chunked prefill (no chunk hooks),
    #: hence prefix sharing, and every KV format but fp32 (engine.py:
    #: 476-513)
    supports_chunked_prefill = False
    supports_prefix_sharing = False
    supports_narrow_kv = False

    def __init__(self, cfg, *, device="cuda", kernels=ops):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.kops = kernels

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        with the reference's tree and distributions (:91-106): the
        decoder's learned positions ``pos_embed`` (max_seq, d) at 0.01."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        pd, d = cfg.pdtype, cfg.d_model

        def ln():
            return {"scale": torch.ones(d, dtype=pd, device=dev),
                    "bias": torch.zeros(d, dtype=pd, device=dev)}

        return {
            "embed": L.embed_init(gen, cfg.vocab, d, pd, dev),
            "pos_embed": L._normal(gen, (cfg.max_seq, d), 0.01, pd, dev),
            "enc_layers": _stack_init(cfg, gen, dev, cfg.n_enc_layers,
                                      ENC_BLOCKS),
            "enc_norm": ln(),
            "dec_layers": _stack_init(cfg, gen, dev, cfg.n_layers,
                                      DEC_BLOCKS),
            "dec_norm": ln(),
            "lm_head": L.embed_init(gen, cfg.vocab, d, pd,
                                    dev).T.contiguous(),
        }

    def head(self, params) -> torch.Tensor:
        return params["lm_head"]

    # -- arena ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   kv_format: str = "fp32") -> dict:
        """{"k", "v"} (L, batch, max_seq, KVH, hd) and {"cross_k",
        "cross_v"} (L, batch, enc_seq, KVH, hd), zeros at the activation
        dtype.  Any format but fp32 raises ``ValueError``."""
        kvf.get(kv_format)
        if kv_format != "fp32":
            raise ValueError(f"kv_format={kv_format!r}: the encdec "
                             f"family's cache is fp32-only")
        cfg = self.cfg
        tail = (cfg.n_kv_heads, cfg.hd)

        def zeros(rows):
            return torch.zeros((cfg.n_layers, batch, rows, *tail),
                               dtype=cfg.adtype, device=self.device)

        return {"k": zeros(max_seq), "v": zeros(max_seq),
                "cross_k": zeros(cfg.enc_seq), "cross_v": zeros(cfg.enc_seq)}

    def seq_axes(self, kv_format: str = "fp32") -> dict:
        """{leaf: index of its sequence axis in the per-layer leaf, -1 for
        none}: the self rows follow max_seq, the cross rows do not."""
        del kv_format
        return {"k": 1, "v": 1, **dict.fromkeys(CROSS, -1)}

    def num_slots(self, cache: dict) -> int:
        return cache["k"].shape[1]

    def slot_view(self, cache: dict, slot: int) -> dict:
        """Slot ``slot``'s region of every leaf across all layers, as views
        (L, 1, ...); ``slot`` a host int in range."""
        nslots = self.num_slots(cache)
        if not (isinstance(slot, int) and 0 <= slot < nslots):
            raise ValueError(f"slot {slot!r}: a slot view takes a host int "
                             f"in [0, {nslots})")
        return {key: leaf[:, slot:slot + 1] for key, leaf in cache.items()}

    # -- drivers -------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor, *,
               remat: str = "full") -> torch.Tensor:
        """frames: (B, enc_seq, d), cast to the activation dtype, plus the
        sinusoidal positions; returns the normed encoder output (B,
        enc_seq, d) (reference :108), each layer under ``remat`` when the
        weights take a gradient (``transformer.remat_call``)."""
        cfg = self.cfg
        adt = cfg.adtype
        x = frames.to(device=self.device, dtype=adt) \
            + L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     self.device).to(adt)
        layers = T.unbind_layers(params["enc_layers"], cfg.n_enc_layers)
        x, _ = T.stack_forward(layers, x, _no_aux(
            lambda lp, xx: enc_layer(lp, cfg, xx, kops=self.kops)), remat)
        return L.layernorm(params["enc_norm"], x, cfg.rms_eps)

    # -- training ------------------------------------------------------------
    def decode_hidden(self, params, tokens: torch.Tensor,
                      enc_out: torch.Tensor, *, remat: str = "full"):
        """The decoder over the whole sequence with no cache (reference
        :120): embeddings plus learned positions [0, S), each layer's
        cross-attention over ``enc_out``; returns the normed hidden states
        (B, S, d)."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = L.embed_lookup(params["embed"], tokens)
        x = x + params["pos_embed"][None, :s].to(x.dtype)
        layers = T.unbind_layers(params["dec_layers"], cfg.n_layers)
        x, _ = T.stack_forward(layers, x, _no_aux(
            lambda lp, xx: dec_train_layer(lp, cfg, xx, enc_out,
                                           kops=self.kops)), remat)
        return L.layernorm(params["dec_norm"], x, cfg.rms_eps)

    def loss_fn(self, params, batch: dict, *, remat: str = "full",
                ce_block: int = 512):
        """batch: {"frames" (B, enc_seq, d), "tokens", "labels", optional
        "loss_mask"} (reference :136): the encoder, the decoder over the
        whole sequence, the blockwise CE; aux is 0."""
        T.check_remat(remat)
        enc_out = self.encode(params, batch["frames"], remat=remat)
        h = self.decode_hidden(params, batch["tokens"], enc_out, remat=remat)
        ce = L.blockwise_cross_entropy(self.head(params), h, batch["labels"],
                                       batch.get("loss_mask"),
                                       block=ce_block)
        return ce, {"ce": ce, "aux": ce.new_zeros(())}

    def prefill(self, params, tokens: torch.Tensor, cache: dict, *,
                frames: torch.Tensor) -> torch.Tensor:
        """The encoder over ``frames``, then the decoder over the prompt
        (reference :152-209): rows [0, S) of ``cache``'s self leaves and
        all of its cross leaves written in place (``cache``: the arena or
        a ``slot_view`` of it); returns the last row's logits (B, V) f32."""
        cfg, kops = self.cfg, self.kops
        eps = cfg.rms_eps
        enc_out = self.encode(params, frames)
        b, s = tokens.shape
        x = L.embed_lookup(params["embed"], tokens)
        x = x + params["pos_embed"][None, :s].to(x.dtype)
        for i in range(cfg.n_layers):
            lp = T.layer_params(params["dec_layers"], i)
            h = L.layernorm(lp["ln1"], x, eps)
            q, k, v = L._project_qkv(lp["self_attn"], cfg, h, None)
            cache["k"][i, :, :s] = k.to(cache["k"].dtype)
            cache["v"][i, :, :s] = v.to(cache["v"].dtype)
            o = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
            x = x + L._dot(o.transpose(1, 2).reshape(b, s, -1),
                           lp["self_attn"]["wo"], cfg.adtype)
            ck, cv = cross_kv(lp, cfg, enc_out)
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
            h = L.layernorm(lp["ln_x"], x, eps)
            x = x + attention(lp["cross_attn"], cfg, h, causal=False,
                              kv=(ck, cv), kops=kops)
            h = L.layernorm(lp["ln2"], x, eps)
            x = x + L.mlp(lp["mlp"], cfg, h, act="gelu")
        h = L.layernorm(params["dec_norm"], x, eps)
        return T.head_logits(h[:, -1], self.head(params))

    def decode_step(self, params, token_t: torch.Tensor, cache: dict,
                    pos: torch.Tensor, share=None) -> torch.Tensor:
        """token_t: (B,) int; pos: (B,) row to write per slot (reference
        :211-243).  Each layer writes its self row in place (masked to pos
        < max_seq, so a parked slot, pos = PARKED_POS, stays untouched),
        attends its rows [0, pos] without RoPE, then all enc_seq cross
        rows; returns logits (B, V) f32.  The learned position of a parked
        slot is clamped to the table's last row, as the reference's
        gather clamps.  ``share`` must be None (no prefix sharing)."""
        if share is not None:
            raise ValueError("the encdec family has no prefix sharing")
        cfg, kops = self.cfg, self.kops
        eps = cfg.rms_eps
        b = token_t.shape[0]
        pe = params["pos_embed"]
        x_t = L.embed_lookup(params["embed"], token_t)
        x_t = x_t + pe[pos.clamp(max=pe.shape[0] - 1)].to(x_t.dtype)
        for i in range(cfg.n_layers):
            lp = T.layer_params(params["dec_layers"], i)
            h = L.layernorm(lp["ln1"], x_t, eps)
            x_t = x_t + L.attention_decode_rows(
                lp["self_attn"], cfg, h, {"k": cache["k"][i],
                                          "v": cache["v"][i]}, pos,
                kops=kops, use_rope=False)
            h = L.layernorm(lp["ln_x"], x_t, eps)
            x_t = x_t + self._cross_decode(lp["cross_attn"], h,
                                           cache["cross_k"][i],
                                           cache["cross_v"][i])
            h = L.layernorm(lp["ln2"], x_t, eps)
            x_t = x_t + L.mlp(lp["mlp"], cfg, h, act="gelu")
        h = L.layernorm(params["dec_norm"], x_t, eps)
        return T.head_logits(h, self.head(params))

    def _cross_decode(self, p, h, ck, cv) -> torch.Tensor:
        """One token's cross-attention over all of a slot's cross rows:
        ``flash_decode`` with ``lengths=None`` (reference layers.py:
        288-303).  h: (B, d); ck / cv: (B, enc_seq, KVH, hd)."""
        cfg = self.cfg
        b = h.shape[0]
        q = L._dot(h, p["wq"], cfg.adtype).reshape(b, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = L.rmsnorm(p["q_norm"], q, cfg.rms_eps)
        o = self.kops.flash_decode(q, ck, cv, lengths=None)
        return L._dot(o.reshape(b, -1), p["wo"], cfg.adtype)

    #: the engine's sampled step, shared with ``LM`` (reference :249): it
    #: needs nothing but ``decode_step``, and the cross K/V are static per
    #: request, so the (seed, position) keys carry over
    decode_and_sample = T.LM.decode_and_sample
