"""Roofline terms of a traced step on one H100 (paper §VI, Fig. 2).

Port of ``repro/core/roofline.py``.  The paper holds Ara against its
roofline: achieved throughput against the compute limit and the memory
diagonal.  The reference derives its terms from a compiled XLA module's
HLO on TPU v5e constants; here they come from the step traced op by op
(``core/cost.py``) on this card's data-sheet constants:

  compute_s    = FLOPs        / the peak of the units that run them
  memory_s     = bytes        / HBM_BW          (HBM limit)
  collective_s = wire bytes   / NVLINK_BW       (NVLink limit)

The collective wire bytes follow the reference's ring formulas
(:class:`CollectiveOp`); on one card there is no collective, so the term
is 0 until the multi-device port (ROADMAP 1.11) fills it.  There is no
``parse_collectives``: there is no HLO text to parse.

The trace times each op's FLOPs at its units' peak (``Cost.compute_s``):
a matmul at the tensor cores' rate for its type, float32 without TF32
and every elementwise op at the CUDA cores' rate, where the reference
takes each FLOP at its chip's one peak.

Constants: NVIDIA H100 SXM5 (80 GB HBM3) data-sheet figures, not
measurements: dense bf16 tensor-core peak 989 TFLOP/s, dense TF32 494.5,
f32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s
a direction.
"""
from __future__ import annotations

import dataclasses

import torch

#: NVIDIA H100 SXM5, dense bf16 on the tensor cores (data sheet)
PEAK_FLOPS = 989e12
#: NVIDIA H100 SXM5, dense TF32 on the tensor cores (data sheet)
TF32_PEAK_FLOPS = 494.5e12
#: NVIDIA H100 SXM5, float32 on the CUDA cores (data sheet)
F32_PEAK_FLOPS = 67e12
#: NVIDIA H100 SXM5, HBM3 (data sheet)
HBM_BW = 3.35e12
#: NVIDIA H100 SXM5, NVLink 4, bytes a second a direction (data sheet)
NVLINK_BW = 450e9

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveOp:
    """One collective: its result bytes on each member and its group size,
    with the reference's ring-schedule wire bytes."""
    kind: str
    result_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        b, s = self.result_bytes, max(self.group_size, 1)
        if s == 1:
            return 0.0 if self.kind != "collective-permute" else float(b)
        if self.kind == "all-reduce":
            return 2.0 * b * (s - 1) / s
        if self.kind == "all-gather":
            return b * (s - 1) / s
        if self.kind == "reduce-scatter":
            return float(b) * (s - 1)
        if self.kind == "all-to-all":
            return b * (s - 1) / s
        return float(b)  # collective-permute


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The work of one kernel launch: its operations, the bytes it must
    move (each input read once, each output written once) and the peak
    rate of its operations' type."""
    name: str
    flops: int
    bytes: int
    flop_rate: float = PEAK_FLOPS

    @property
    def bytes_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def ops_s(self) -> float:
        return self.flops / self.flop_rate

    @property
    def bound_s(self) -> float:
        """The least time the card could take: max(bytes / HBM,
        operations / peak)."""
        return max(self.bytes_s, self.ops_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


def peak_for(dtype, *, tf32: bool = False) -> float:
    """The peak of a kernel's or a matmul's operations by its operand
    type: float32 on the CUDA cores (on the tensor cores at TF32's rate
    where ``tf32``), every narrower type on the tensor cores."""
    if dtype == torch.float32:
        return TF32_PEAK_FLOPS if tf32 else F32_PEAK_FLOPS
    return PEAK_FLOPS


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    collective_counts: dict
    model_flops_per_chip: float = 0.0
    #: the FLOPs' time, each at the peak of the units that run it
    #: (``Cost.compute_s``; the reference takes every FLOP at one peak)
    compute_s_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.compute_s_per_chip

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_chip / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much of the step's compute is
        useful."""
        if self.flops_per_chip <= 0:
            return 0.0
        return self.model_flops_per_chip / self.flops_per_chip

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: (model_flops / PEAK) /
        max(terms).  1.0 is a step of pure, perfectly overlapped useful
        math at the tensor-core peak."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops_per_chip / PEAK_FLOPS) / self.bound_s

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collective_counts,
        }


def measured_fraction(model_flops: float, step_s: float) -> float:
    """The roofline fraction a measured step reaches: (model_flops / PEAK)
    / the step's time, the model-FLOP share of the tensor-core peak."""
    return model_flops / PEAK_FLOPS / step_s if step_s > 0 else 0.0


def derive(cost, *, model_flops_global: float = 0.0,
           n_chips: int = 1) -> RooflineTerms:
    """Roofline terms of a traced step's :class:`core.cost.Cost` (the
    reference derives them from a compiled module's HLO).  The trace is
    one card's program, so its costs are per chip; ``model_flops_global``
    is divided by ``n_chips``."""
    return RooflineTerms(
        flops_per_chip=cost.flops,
        hbm_bytes_per_chip=cost.bytes,
        wire_bytes_per_chip=cost.wire_bytes,
        collective_counts=dict(cost.collective_counts),
        model_flops_per_chip=model_flops_global / max(n_chips, 1),
        compute_s_per_chip=cost.compute_s,
    )
