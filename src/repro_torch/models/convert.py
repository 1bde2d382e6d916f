"""Weights bridge: the JAX package's parameter tree -> the port's.

The reference LM's parameters (``transformer.py:335-346``) are a nested
dict: ``embed``, ``layers`` (dense: ``{ln1,attn.{wq,wk,wv,wo,q_norm?,
k_norm?},ln2,mlp.{w_up,w_gate?,w_down}}``; moe: the dense layer's leaves
with ``moe.{router,experts.{w_gate,w_up,w_down},shared?.{w_up,w_gate,
w_down},shared_gate?}`` in place of ``mlp``, moe.py:31; ssm: ``{ln,mamba.
{w_z,w_x,w_B,w_C,w_dt,conv,A_log,dt_bias,D,norm,w_out}}``, mamba2.py:23;
hybrid: the dense layer's leaves with ``attn_norm``, ``mamba`` and
``mamba_norm``, hybrid.py:32), each leaf
stacked on a leading L axis, ``final_norm`` and ``lm_head`` (absent when
embeddings are tied).  The port keeps that layout exactly, so the bridge
is a checked leaf-by-leaf copy.  Every leaf takes ``cfg.param_dtype``
except the mamba branch's ``A_log``/``dt_bias``/``D`` (ssm and hybrid)
and the moe router, which are float32 whatever the param dtype, as in the
reference (mamba2.py:42-44, moe.py:46-47).
Callers hand the tree over as numpy arrays (``np.asarray`` of each leaf),
so this module never sees a JAX type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import device as device_mod


#: leaves kept in float32 whatever the param dtype
F32_LEAVES = ("layers.mamba.A_log", "layers.mamba.dt_bias", "layers.mamba.D",
              "layers.moe.router")


def _mamba_shapes(cfg) -> dict:
    s, d, nl = cfg.ssm, cfg.d_model, cfg.n_layers
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    m = "layers.mamba."
    return {
        m + "w_z": (nl, d, di), m + "w_x": (nl, d, di),
        m + "w_B": (nl, d, gn), m + "w_C": (nl, d, gn),
        m + "w_dt": (nl, d, nh), m + "conv": (nl, s.conv_width, di + 2 * gn),
        m + "A_log": (nl, nh), m + "dt_bias": (nl, nh), m + "D": (nl, nh),
        m + "norm.scale": (nl, di), m + "w_out": (nl, di, d),
    }


def _moe_shapes(cfg) -> dict:
    me, d, nl = cfg.moe, cfg.d_model, cfg.n_layers
    e, f = me.n_experts, me.d_ff_expert
    m = "layers.moe."
    shapes = {m + "router": (nl, d, e),
              m + "experts.w_gate": (nl, e, d, f),
              m + "experts.w_up": (nl, e, d, f),
              m + "experts.w_down": (nl, e, f, d)}
    if me.n_shared_experts:
        fs = me.d_ff_shared
        shapes.update({m + "shared.w_up": (nl, d, fs),
                       m + "shared.w_gate": (nl, d, fs),
                       m + "shared.w_down": (nl, fs, d),
                       m + "shared_gate": (nl, d, 1)})
    return shapes


def expected_shapes(cfg) -> dict:
    """The LM's parameter tree as {path: shape} (dense, moe, ssm or
    hybrid)."""
    d, hd, nl = cfg.d_model, cfg.hd, cfg.n_layers
    if cfg.family == "ssm":
        shapes = {"embed": (cfg.vocab, d), "layers.ln.scale": (nl, d),
                  **_mamba_shapes(cfg), "final_norm.scale": (d,)}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (d, cfg.vocab)
        return shapes
    shapes = {
        "embed": (cfg.vocab, d),
        "layers.ln1.scale": (nl, d),
        "layers.attn.wq": (nl, d, cfg.n_heads * hd),
        "layers.attn.wk": (nl, d, cfg.n_kv_heads * hd),
        "layers.attn.wv": (nl, d, cfg.n_kv_heads * hd),
        "layers.attn.wo": (nl, cfg.n_heads * hd, d),
        "layers.ln2.scale": (nl, d),
        "final_norm.scale": (d,),
    }
    if cfg.qk_norm:
        shapes["layers.attn.q_norm.scale"] = (nl, hd)
        shapes["layers.attn.k_norm.scale"] = (nl, hd)
    if cfg.family == "moe":
        shapes.update(_moe_shapes(cfg))
    else:
        shapes["layers.mlp.w_up"] = (nl, d, cfg.d_ff)
        shapes["layers.mlp.w_down"] = (nl, cfg.d_ff, d)
        if cfg.act == "silu_gated":
            shapes["layers.mlp.w_gate"] = (nl, d, cfg.d_ff)
    if cfg.family == "hybrid":
        shapes.update({"layers.attn_norm.scale": (nl, d),
                       "layers.mamba_norm.scale": (nl, d),
                       **_mamba_shapes(cfg)})
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
    port's parameters on ``device``, at ``cfg.param_dtype`` (float32 for
    :data:`F32_LEAVES`).  Raises on a missing, extra or mis-shaped leaf."""
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
        dtype = torch.float32 if path in F32_LEAVES else cfg.pdtype
        node[leaf] = t.to(device=dev, dtype=dtype)
    return params
