"""Cost model of a traced step, op by op (the port's ``hlo_analysis``).

Port of ``repro/core/hlo_analysis.py``.  The reference walks a compiled
module's optimized HLO with trip counts; eager PyTorch has no such module,
so the port traces the step itself: :class:`CostMode` (a
``TorchDispatchMode``) sees every aten op the step runs, whatever builds
it (a Python loop over layers, autograd's backward, a checkpoint's
recompute), and charges it by the reference's rules:

  * matmul (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``dot`` / ``mv``)
    — 2 · |result| · K FLOPs, a convolution the same way with K the
    kernel's taps times its input channels a group;
  * elementwise — |result| FLOPs, a reduction |operand|; transcendentals
    (exp, log, rsqrt, tanh, sigmoid, softmax, ...) counted apart too;
  * bytes — operands + result an op: in eager PyTorch every op is a
    kernel that reads its operands and writes its result, so this is the
    honest memory model (a broadcast operand counts its distinct
    elements once);
  * views — free;
  * an in-place write into a slice (``copy_``, ``index_copy_``,
    ``index_put_``, ``scatter_``) — the update's size, read and written
    (the reference's dynamic-update-slice rule), not the buffer's;
  * a gather or index (``index``, ``index_select``, ``gather``,
    ``embedding``) — the slice's size, read and written, with its indices.

Each op's FLOPs are also timed at the peak of the units that run them
(``Cost.compute_s``, which ``roofline.derive`` takes as the compute
term): a matmul or convolution at the rate of its type
(``roofline.peak_for``: float32 on the CUDA cores, or at TF32's rate
where PyTorch allows TF32), every other op at the CUDA cores' float32 rate
(PyTorch's elementwise and reduction kernels compute bf16 and f16 in
float32).

A hand-written kernel is charged once, from its module's ``cost()`` (the
kernel table's work: each input read once, each output written once, at
the rate of its type), through a model built with
``kernels/counting.counting_kernels`` in place of ``kernels/ops.py``.  A
costed call reads shapes only, never a tensor's values, so the same step
counts the same integers on meta, on the CPU and on the card.

The mode also keeps the live bytes of the trace by storage (each storage
counted from the op that makes it until it is freed, the tensors handed
to :meth:`CostMode.track` from the start): its peak is the counterpart of
``memory_analysis()``'s argument plus temp sizes.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

from repro_torch.core import roofline


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    transcendentals: float = 0.0
    dot_flops: float = 0.0
    #: seconds of the FLOPs at the peak of the units that run them (the
    #: port's own field: the reference has one peak for every FLOP)
    compute_s: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_wire: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    warnings: list = dataclasses.field(default_factory=list)

    def _ops(self, flops: float,
             rate: float = roofline.F32_PEAK_FLOPS) -> None:
        self.flops += flops
        self.compute_s += flops / rate

    def _charge(self, op: str, b: float):
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b

    def counts(self) -> dict:
        """The integers a trace counts, for comparing two traces."""
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "dot_flops": self.dot_flops, "compute_s": self.compute_s,
                "bytes_by_op": dict(sorted(self.bytes_by_op.items()))}


# ---------------------------------------------------------------------------
# op classes (aten overload packets by name)
# ---------------------------------------------------------------------------

_FREE = {
    "detach", "alias", "lift_fresh", "_unsafe_view", "view", "t",
    "transpose", "permute", "expand", "squeeze", "unsqueeze", "select",
    "slice", "split", "split_with_sizes", "unbind", "narrow", "as_strided",
    "diagonal", "unfold", "_reshape_alias", "view_as_real",
    "view_as_complex", "_conj", "_neg_view", "real", "imag", "set_",
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "detach_", "requires_grad_",
    "_local_scalar_dense", "resize_", "_has_compatible_shallow_copy_type",
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv",
           "addmv"}
_CONV = {"convolution", "_convolution"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "sin", "cos", "tan", "tanh", "sigmoid", "silu", "gelu", "erf",
    "erfc", "erfinv", "pow", "softplus", "atan2", "sinh", "cosh", "asin",
    "acos", "atan", "logit", "mish", "elu", "tanh_backward",
    "sigmoid_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "_softmax",
    "_log_softmax", "logsumexp", "logcumsumexp",
}
#: reductions without the ``reduction`` tag
_REDUCE = {"cumsum", "cumprod", "_softmax", "_log_softmax",
           "_softmax_backward_data", "_log_softmax_backward_data",
           "nll_loss_forward", "nll_loss_backward", "sort", "topk",
           "logcumsumexp", "cummax", "cummin", "argsort"}
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding",
           "take"}
#: in-place writes into a slice: (the update's operand position, its
#: index operand's position or None)
_SLICE_WRITE = {"index_put_": (2, 1), "_index_put_impl_": (2, 1),
                "index_copy_": (3, 2), "scatter_": (3, 2),
                "scatter_add_": (3, 2), "index_add_": (3, 2),
                "masked_scatter_": (2, 1)}
#: the ops whose bytes :func:`copied_bytes` sums: copies and slice writes
COPY_OPS = ("copy", "clone", "copy_") + tuple(_SLICE_WRITE)

#: elementwise ops without the ``pointwise`` tag
_POINTWISE = {"floor_divide", "threshold_backward", "clamp_min",
              "clamp_max", "where"}

#: ops charged operands + result with no FLOPs
_LAYOUT = {"cat", "stack", "constant_pad_nd", "repeat", "repeat_interleave",
           "flip", "roll", "tril", "triu", "slice_scatter", "select_scatter",
           "index_copy", "index_put", "scatter", "scatter_add", "index_add",
           "masked_scatter", "embedding_dense_backward", "fill_", "zero_",
           "zeros_like", "ones_like", "full_like", "_unsafe_index_put",
           "new_zeros", "new_ones", "new_full", "rand_like", "randn_like",
           "bernoulli_", "uniform_", "normal_", "slice_backward",
           "select_backward", "index_select_backward", "unfold_backward",
           "diagonal_backward", "as_strided_scatter"}


def _distinct(t: torch.Tensor) -> int:
    """Elements a tensor addresses, a broadcast (stride-0) axis once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _nbytes(t: torch.Tensor) -> int:
    return _distinct(t) * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _charge_op(c: Cost, func, args, kwargs, out) -> None:
    name = func.overloadpacket.__name__
    if name in _FREE or func.is_view:
        return
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    relems = sum(t.numel() for t in outs)
    rbytes = sum(_nbytes(t) for t in outs)
    in_bytes = sum(_nbytes(t) for t in ins)
    if name in _MATMUL or name in _CONV or name == "convolution_backward":
        if name in _MATMUL:       # K: the first factor's last axis
            a = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
                else args[0]
            flops = 2.0 * relems * a.shape[-1]
            dt, tf32 = a.dtype, torch.backends.cuda.matmul.allow_tf32
        else:                     # K: the kernel's taps x input channels
            w = args[1] if name in _CONV else args[2]
            k = math.prod(w.shape[1:])
            flops = (2.0 * relems * k if name in _CONV
                     else 2.0 * 2.0 * args[0].numel() * k)   # dx and dw
            dt, tf32 = args[0].dtype, torch.backends.cudnn.allow_tf32
        c._ops(flops, roofline.peak_for(dt, tf32=tf32))
        c.dot_flops += flops
        c._charge(name, in_bytes + rbytes)
        return
    if name == "copy_":
        c._charge(name, _nbytes(args[1]) + _nbytes(args[0]))
        return
    if name in _SLICE_WRITE:
        upd, idx = _SLICE_WRITE[name]
        update = args[upd] if len(args) > upd else kwargs.get("source")
        ib = sum(_nbytes(t) for t in _tensors(args[idx])) \
            if idx is not None else 0
        if isinstance(update, torch.Tensor):
            ub = _nbytes(update)
            if name in ("scatter_add_", "index_add_"):
                c._ops(update.numel())
        else:                       # a scalar written at each index
            ub = _tensors(args[idx])[0].numel() * args[0].element_size()
        c._charge(name, 2.0 * ub + ib)
        return
    if name in _GATHER:
        idx_bytes = sum(_nbytes(t) for t in ins[1:]) if name != "embedding" \
            else _nbytes(args[1])
        c._charge(name, 2.0 * rbytes + idx_bytes)
        return
    if name in ("clone", "copy"):
        c._charge(name, in_bytes + rbytes)
        return
    if name == "_to_copy":
        same = all(t.dtype == args[0].dtype for t in outs)
        if not same:
            c._ops(relems)                     # a conversion: elementwise
        c._charge("copy" if same else name, in_bytes + rbytes)
        return
    reduction = torch.Tag.reduction in func.tags or name in _REDUCE
    if name in _TRANSCENDENTAL:
        n = ins[0].numel() if reduction else relems
        c._ops(n)
        c.transcendentals += n
        c._charge(name, in_bytes + rbytes)
        return
    if reduction:
        c._ops(ins[0].numel())
        c._charge(name, in_bytes + rbytes)
        return
    if torch.Tag.pointwise in func.tags or name in _POINTWISE:
        c._ops(relems)
        c._charge(name, in_bytes + rbytes)
        return
    if not ins:                                # a factory: its result written
        c._charge(name, rbytes)
        return
    if name not in _LAYOUT:
        w = f"unknown op {name!r} treated as layout"
        if w not in c.warnings:
            c.warnings.append(w)
    c._charge(name, in_bytes + rbytes)


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------

class CostMode(TorchDispatchMode):
    """Charge every aten op dispatched while active into ``self.cost``
    and keep the trace's live and peak bytes (``live_bytes``,
    ``peak_bytes``).

    The step's device is that of the first tensor :meth:`track` is given
    (its arguments).  Ops with no tensor on it are host bookkeeping, not
    the step's work, and are not charged: on the card, the CPU copy of the
    CUDA RNG state that ``torch.utils.checkpoint`` restores before each
    recompute (``torch.cuda.set_rng_state`` clones it), which a meta or a
    CPU trace does not make.  Untracked, every op is charged."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.kernels: dict[str, int] = {}
        self.device: Optional[str] = None
        self._storages: dict[int, int] = {}

    # -- memory --------------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now on
        (the step's arguments: parameters, optimizer state, arena,
        batch)."""
        for t in _tensors(tree):
            if self.device is None:
                self.device = t.device.type
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _on_device(self, ts) -> bool:
        return self.device is None or any(t.device.type == self.device
                                          for t in ts)

    def _see(self, t: torch.Tensor) -> None:
        if not self._on_device((t,)):
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._storages:
            return
        n = s.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        weakref.finalize(s, _freed, weakref.ref(self), key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # -- charging ------------------------------------------------------------
    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._on_device(_tensors((args, kwargs)) + outs):
            _charge_op(self.cost, func, args, kwargs, out)
        for t in outs:
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def charge_kernel(self, work: roofline.KernelCost, outs=()) -> None:
        """One hand-written kernel launch: its work's FLOPs at its type's
        peak and its bytes (``dot_flops`` too: the kernels' work is
        products), and its outputs' storages made live."""
        c = self.cost
        c._ops(work.flops, work.flop_rate)
        c.dot_flops += work.flops
        c._charge(work.name, work.bytes)
        self.kernels[work.name] = self.kernels.get(work.name, 0) + 1
        for t in _tensors(outs):
            self._see(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)


def _freed(mode_ref, key) -> None:
    mode = mode_ref()
    if mode is not None:
        mode._free(key)


def active() -> Optional[CostMode]:
    """The innermost :class:`CostMode` on the dispatch mode stack (which
    autograd carries into its backward), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


def copied_bytes(cost: Cost) -> float:
    """Bytes a step spends materialising copies: ``clone`` and same-dtype
    ``_to_copy`` (the bucket ``copy``) plus the in-place slice writes
    (``copy_``, ``index_put_``, ``index_copy_``, ``scatter_``, ...), each
    at the update's size (the reference's ``copied_bytes``: copies plus
    dynamic-update-slice / scatter traffic)."""
    by = cost.bytes_by_op
    return float(sum(by.get(k, 0.0) for k in COPY_OPS))


def resident_bytes(tree) -> dict:
    """Device-resident footprint of a tree of tensors (meta tensors
    included: shape x itemsize).  The trace's peak live bytes, the
    counterpart of the compiled executable's memory analysis, are
    :attr:`CostMode.peak_bytes`."""
    return {"resident": float(sum(t.numel() * t.element_size()
                                  for t in _tensors(tree)))}
