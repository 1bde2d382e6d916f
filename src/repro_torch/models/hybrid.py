"""Hymba-style hybrid layer and the hybrid family's layer set
[arXiv:2411.13676].

Port of ``repro/models/hybrid.py``: each layer runs an attention branch and
a Mamba2 (SSD) branch on the same normed input side by side, normalises
each branch's output and averages them, then a gated MLP.  Most layers
attend through a sliding window (``cfg.attn_window``); ``n_global_layers``
of them (first / middle / last) attend globally, their window
``cfg.max_seq + 1`` (:func:`window_schedule`).  The reference threads the
schedule through its layer scan; the driver here passes layer i's window
to its layer functions as a host int (``LayerSet.windows``).

One arena holds both kinds of leaf, written in place:

    {"k", "v": (L, slots, max_seq, KVH, hd) at the activation dtype,
     "ssm": (L, slots·nh, N, P) f32, "conv": (L, slots, W-1, di+2gn)}

The attention branch is ``layers.attention_chunk`` / ``attention_decode_rows``
/ ``transformer.attention_prefill`` with the layer's window (the three
attention kernels), the SSD branch ``mamba2``'s branch functions (the
``ssd`` kernel).  Under prefix sharing the attention branch reads the
donor's rows through the kernels' donor table; the SSD branch has no
sequence axis, so a fork's share of its state was spliced in at the fork.
The arena takes only the ``fp32`` format (stored at the activation dtype),
as the reference's ``init_hybrid_cache`` takes no ``kv_format``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as T


def window_schedule(cfg) -> list:
    """One attention window a layer (reference :22): layers {0, L//2,
    L-1} (the first ``n_global_layers`` when fewer than 3) get
    ``cfg.max_seq + 1``, which no position reaches (global), the rest
    ``cfg.attn_window``."""
    n = cfg.n_layers
    glob = ({0, n // 2, n - 1} if cfg.n_global_layers >= 3
            else set(range(cfg.n_global_layers)))
    return [cfg.max_seq + 1 if i in glob else cfg.attn_window
            for i in range(n)]


def hybrid_layer_init(cfg, gen, dev) -> dict:
    """The stacked hybrid layer tree (reference :32): the dense layer's
    ``ln1`` / ``attn`` / ``ln2`` / ``mlp``, the Mamba2 branch ``mamba``,
    and the branch output norms ``attn_norm`` / ``mamba_norm`` (unit)."""
    tree = T._dense_init_params(cfg, gen, dev)
    ones = {"scale": torch.ones((cfg.n_layers, cfg.d_model),
                                dtype=cfg.pdtype, device=dev)}
    tree.update(attn_norm=ones, mamba_norm={"scale": ones["scale"].clone()},
                mamba=mamba2.mamba_params_init(cfg, gen, dev))
    return tree


def init_hybrid_cache(cfg, batch: int, max_seq: int, kv_format: str,
                      device) -> dict:
    """The stacked arena: the K/V rows of ``layers.init_kv_cache`` beside
    the SSD state and conv tail of ``mamba2.init_ssm_cache`` (reference
    :128).  ``LM.init_cache`` admits only the fp32 format here."""
    return {**L.init_kv_cache(cfg, batch, max_seq, kv_format=kv_format,
                              device=device, n_layers=cfg.n_layers),
            **mamba2.init_ssm_cache(cfg, batch, max_seq, kv_format,
                                    device)}


def _combine(p, cfg, x, a, m):
    """x + the mean of the two normed branch outputs, then the MLP."""
    eps = cfg.rms_eps
    x = x + 0.5 * (L.rmsnorm(p["attn_norm"], a, eps)
                   + L.rmsnorm(p["mamba_norm"], m, eps))
    h2 = L.rmsnorm(p["ln2"], x, eps)
    return x + L.mlp(p["mlp"], cfg, h2)


def hybrid_prefill_layer(p, cfg, x, view_l, positions, *, window,
                         kops=ops):
    """Monolithic prefill through both branches (reference :135): the
    attention branch fills K/V rows [0, S) of the (slot's) arena view,
    the SSD branch leaves its final state and conv tail there."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    a = T.attention_prefill(p["attn"], cfg, h, view_l, positions,
                            window=window, kops=kops)
    m = mamba2.ssm_prefill_branch(p["mamba"], cfg, h, view_l, kops=kops)
    return _combine(p, cfg, x, a, m)


def hybrid_layer_chunk(p, cfg, x, layer_l, slot, positions, start, nvalid,
                       prefix, *, window, kops=ops, share=None):
    """One prompt chunk through both branches into arena slot ``slot``
    (reference :93): the chunk's K/V rows appended and attended over the
    slot's prefix within the layer's window (the donor table ``share``
    reads a fork's shared rows), the SSD recurrence carried through the
    slot's state (reset at start 0, padding kept out by ``nvalid``)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    a = L.attention_chunk(p["attn"], cfg, h, layer_l, slot, positions,
                          start, prefix, window=window, kops=kops,
                          share=share)
    m = mamba2.ssm_chunk_branch(p["mamba"], cfg, h, layer_l, slot, start,
                                nvalid, kops=kops)
    return _combine(p, cfg, x, a, m)


def hybrid_layer_decode_rows(p, cfg, x_t, view_l, pos, *, window, kops=ops,
                             share=None):
    """One decode step through both branches (reference :59): the token's
    K/V row written at ``pos`` and attended within the window, the SSD
    state stepped; a parked slot (pos = PARKED_POS) keeps every leaf."""
    h = L.rmsnorm(p["ln1"], x_t, cfg.rms_eps)
    a = L.attention_decode_rows(p["attn"], cfg, h, view_l, pos,
                                window=window, kops=kops, share=share)
    m = mamba2.ssm_decode_branch(p["mamba"], cfg, h, view_l, pos, kops=kops)
    return _combine(p, cfg, x_t, a, m)


def hybrid_train_layer(p, cfg, x, positions, *, window, kops=ops):
    """One hybrid layer of the training forward (reference
    ``hybrid_layer_apply``, :44): both branches on one normed input, the
    attention branch causal within the layer's window with no cache, the
    SSD branch from a zero state; then :func:`_combine`.  Returns (x, aux
    = 0)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    a = L.attention(p["attn"], cfg, h, positions=positions, causal=True,
                    window=window, kops=kops)
    m = mamba2.mamba_apply(p["mamba"], cfg, h, kops=kops)
    return (_combine(p, cfg, x, a, m),
            x.new_zeros((), dtype=torch.float32))


def _factors(cfg) -> dict:
    return {"k": 1, "v": 1, "ssm": cfg.ssm.n_heads(cfg.d_model), "conv": 1}


#: the hybrid family: K/V rows beside the SSD state, the three attention
#: kernels (each layer's window) and ``ssd`` (and in training the attention
#: and SSD backward kernels)
HYBRID = T.LayerSet(
    init_params=hybrid_layer_init, init_cache=init_hybrid_cache,
    factors=_factors, prefill_layer=hybrid_prefill_layer,
    chunk_layer=hybrid_layer_chunk, decode_layer=hybrid_layer_decode_rows,
    train_layer=hybrid_train_layer, windows=window_schedule)
