"""Weights bridge: the JAX package's parameter tree -> the port's.

The reference LM's parameters (``transformer.py:335-346``) are a nested
dict: ``embed``, ``layers.{ln1,attn.{wq,wk,wv,wo,q_norm?,k_norm?},ln2,
mlp.{w_up,w_gate?,w_down}}`` (each leaf stacked on a leading L axis),
``final_norm`` and ``lm_head`` (absent when embeddings are tied).  The port
keeps that layout exactly, so the bridge is a checked leaf-by-leaf copy.
Callers hand the tree over as numpy arrays (``np.asarray`` of each leaf),
so this module never sees a JAX type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import device as device_mod


def expected_shapes(cfg) -> dict:
    """The dense LM's parameter tree as {path: shape}."""
    d, hd, nl = cfg.d_model, cfg.hd, cfg.n_layers
    shapes = {
        "embed": (cfg.vocab, d),
        "layers.ln1.scale": (nl, d),
        "layers.attn.wq": (nl, d, cfg.n_heads * hd),
        "layers.attn.wk": (nl, d, cfg.n_kv_heads * hd),
        "layers.attn.wv": (nl, d, cfg.n_kv_heads * hd),
        "layers.attn.wo": (nl, cfg.n_heads * hd, d),
        "layers.ln2.scale": (nl, d),
        "layers.mlp.w_up": (nl, d, cfg.d_ff),
        "layers.mlp.w_down": (nl, cfg.d_ff, d),
        "final_norm.scale": (d,),
    }
    if cfg.qk_norm:
        shapes["layers.attn.q_norm.scale"] = (nl, hd)
        shapes["layers.attn.k_norm.scale"] = (nl, hd)
    if cfg.act == "silu_gated":
        shapes["layers.mlp.w_gate"] = (nl, d, cfg.d_ff)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def _flatten(tree, prefix="") -> dict:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """Convert the reference's parameter tree (numpy leaves) into the
    port's parameters on ``device``, at ``cfg.param_dtype``.  Raises on a
    missing, extra or mis-shaped leaf."""
    dev = device_mod.resolve(device)
    flat = _flatten(tree)
    want = expected_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(want) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(want))}")
    params: dict = {}
    for path, shape in want.items():
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {shape}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        node = params
        *parents, leaf = path.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = t.to(device=dev, dtype=cfg.pdtype)
    return params
