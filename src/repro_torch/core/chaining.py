"""Chaining (paper §VI.A.b — C5): the multiply chained into the reduction.

Port of ``chained_mulreduce`` from ``repro/core/chaining.py``.  In Ara the
SIMD multiplier and the adder are separate functional units, so a
``vfmul`` chains into a ``vfredsum``; the fused kernel form is
``kernels/dotp.py``.  At the step scale, :func:`grad_accum_chained` sums
microbatch gradients (reference :31); its ``reduce_fn`` (the data-parallel
reduction chained into the next microbatch's compute) needs the
multi-device port.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import tree as tree_mod


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """(loss, grads) of ``loss_fn(params, batch) -> scalar`` with respect
    to every leaf of ``params`` (``jax.value_and_grad``): the leaves take
    a gradient for the call only, and come back as they were; a leaf the
    loss does not reach gets zeros.  The loss comes back detached."""
    leaves = tree_mod.leaves(params)
    was = [t.requires_grad for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t, w in zip(leaves, was):
            t.requires_grad_(w)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_mod.unflatten(params, grads)


def grad_accum_chained(loss_fn: Callable, params: Any, batch: dict, *,
                       num_microbatches: int,
                       reduce_fn: Optional[Callable] = None):
    """Gradient accumulation over microbatches (reference :31-75).

    ``loss_fn(params, microbatch) -> scalar loss``; every tensor of
    ``batch`` has a leading batch dim divisible by ``num_microbatches``.
    One microbatch: its (loss, grads), the grads in the params' dtypes.
    More: the microbatches in order, each gradient added in f32 to a zero
    f32 tree, then loss sum and gradients times 1 / n, as the reference's
    scan does.  Returns (mean loss, grads)."""
    if reduce_fn is not None:
        raise NotImplementedError(
            "reduce_fn (the chained data-parallel reduction) comes with the "
            "multi-device port: ROADMAP 1.11")
    if num_microbatches == 1:
        return value_and_grad(loss_fn, params, batch)
    n = num_microbatches
    micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in batch.items()}
    loss_sum = None
    acc = tree_mod.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    for i in range(n):
        loss, grads = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in micro.items()})
        for a, g in zip(tree_mod.leaves(acc), tree_mod.leaves(grads)):
            a.add_(g.float())
        del grads
        loss = loss.float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    scale = 1.0 / n
    return loss_sum * scale, tree_mod.map_(lambda g: g * scale, acc)


def chained_mulreduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """vfmul→vfredsum as one expression: the product is taken in the
    *input* dtype and only the sum in float32, as the reference's
    ``jnp.sum(a * b, dtype=float32)`` does (``ops.dotp``'s plain version
    widens before it multiplies; for bf16 the two differ)."""
    return (a * b).sum(dtype=torch.float32)
