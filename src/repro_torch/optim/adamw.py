"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``: moments in f32 whatever the parameter
dtype, decay on matrices only (``ndim >= decay_min_ndim``), the update
computed in f32 and cast to the parameter's dtype once (:62-70).

The reference maps the update over the whole tree at once.  Here the
leaves are walked one at a time, in the reference's tree order, and the
moments and parameters are updated in place: at llama3.2-3b's width an
f32 copy of every gradient at once would add 14.4 GB.  ZeRO-1 (sharded
moments) belongs to the multi-device port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # decay applies only to matrices (ndim >= 2) — norms/biases exempt
    decay_min_ndim: int = 2


def adamw_init(params: Any) -> dict:
    """f32 zero moments shaped like ``params`` and an int32 step, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_mod.leaves(params)[0].device
    return {"m": tree_mod.map_(zeros, params),
            "v": tree_mod.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (tree order) of each leaf's f32 sum of
    squares; one f32 copy of a leaf at a time."""
    total = None
    for leaf in tree_mod.leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm), the scaled leaves
    in f32."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_mod.map_(lambda g: g.float() * scale, grads), gn


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, in place: ``params`` and ``state``'s ``m`` / ``v``
    are updated leaf by leaf, ``state["step"]`` advanced.  ``lr``: a 0-d
    tensor (or float).  Returns (params, state, {"grad_norm": 0-d f32}),
    the same objects, as the reference returns its new trees."""
    gn = global_norm(grads)
    scale = (_clip_scale(gn, cfg.clip_norm) if cfg.clip_norm is not None
             else None)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    flat = zip(tree_mod.leaves(params), tree_mod.leaves(grads),
               tree_mod.leaves(state["m"]), tree_mod.leaves(state["v"]))
    for p, g, m, v in flat:
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        if p.ndim >= cfg.decay_min_ndim and cfg.weight_decay:
            delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        del g, delta, p32
    state["step"] = step
    return params, state, {"grad_norm": gn}
