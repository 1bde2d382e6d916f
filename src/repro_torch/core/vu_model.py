"""Cycle-level analytical model of the Ara VU1.0 vector unit.

Port of ``benchmarks/vu_model.py`` (kept as a copy on the port's
``configs/ara_vu.py``: the port imports nothing of the JAX package).
Calibrated against the paper's own numbers (Fig. 2 knees, Table II cycle
counts); every benchmark that reproduces a paper artifact evaluates this
model and, where possible, cross-checks it against executable semantics
(``core.reduction.lane_tree_reduce``) or the measured kernels.

Model elements (all in cycles, per the paper):

  * lane datapath: 64-bit, 1 element/lane/cycle, FMA = 2 FLOP ⇒ peak
    2·ℓ DP-FLOP/cycle (§II: 4-lane unit at 1.34 GHz ⇒ 10.4 DP-GFLOPS ✓).
  * issue rate: 1 computational vector instruction / 4 cycles with RVV 1.0
    (1/5 with RVV 0.5's ``vins`` overhead) (§VI.A).
  * vector instruction on VL elements: VL/ℓ occupation cycles.
  * reduction (§V.e): intra-lane VL_B/(8ℓ) + chained-op + log2(ℓ) ALU
    steps + L_SLIDE·log2(ℓ) inter-lane latency + log2(8/EEW) SIMD fold
    + C0 startup.  C0 and L_SLIDE are calibrated to Table II (13, 3).
"""
from __future__ import annotations

import math

from repro_torch.configs.ara_vu import CONFIG as VU

C0_STARTUP = 13.0       # fixed pipeline startup/drain (calibrated, Table II)
L_SLIDE = 3.0           # per-step inter-lane slide latency (calibrated)


def matmul_cycles(n: int, lanes: int, *, issue_rate: float = VU.issue_rate,
                  startup: float = 10.0) -> dict:
    """fmatmul n×n×n on ℓ lanes (Fig. 2 model).

    n² vfmacc instructions of VL=n elements; each occupies n/ℓ lane cycles;
    the scalar core can issue one every 1/issue_rate cycles.  The unit is
    the max of the two (perfect overlap — chaining), plus a per-column
    pipeline drain.
    """
    compute = n ** 3 / lanes                 # occupation of the FPUs
    issue = n ** 2 / issue_rate              # dispatcher serialisation
    drain = startup * n                      # per C-column chain startup
    total = max(compute, issue) + drain
    peak_flops_cycle = 2 * lanes
    util = (2 * n ** 3 / total) / peak_flops_cycle
    return {
        "n": n, "lanes": lanes, "cycles": total,
        "compute_cycles": compute, "issue_cycles": issue,
        "utilization": util,
        "gflops_at_1_34GHz": 2 * n ** 3 / total * 1.34,
    }


def reduction_cycles(vl_bytes: int, lanes: int, eew_bytes: int) -> dict:
    """Dot-product (vfmul chained into vfredsum) cycles — Table II model."""
    ideal = vl_bytes / (8 * lanes) + 1 + math.log2(lanes)
    actual = (ideal + C0_STARTUP + L_SLIDE * math.log2(lanes)
              + math.log2(8 // eew_bytes) if eew_bytes < 8
              else ideal + C0_STARTUP + L_SLIDE * math.log2(lanes))
    return {
        "vl_bytes": vl_bytes, "lanes": lanes, "eew_bytes": eew_bytes,
        "ideal_cycles": ideal, "model_cycles": actual,
        "efficiency": ideal / actual,
    }


def conv2d_cycles(h: int, w: int, cin: int, cout: int, k: int,
                  lanes: int, *, issue_rate: float = VU.issue_rate) -> dict:
    """fconv2d k×k (im2col-style row strips) — §VI.A model."""
    ho, wo = h - k + 1, w - k + 1
    flops = 2 * ho * wo * cin * cout * k * k
    # one vfmacc per (out-row, kernel-tap, cin, cout) over VL=wo elements
    n_instr = ho * k * k * cin * cout
    issue = n_instr / issue_rate
    occupation = n_instr * (wo / lanes)
    total = max(occupation, issue) + 10 * ho
    util = flops / (total * 2 * lanes)
    return {"hw": (h, w), "k": k, "cin": cin, "cout": cout, "lanes": lanes,
            "cycles": total, "utilization": util}


# Paper Table II reference values: (lanes, vl_bytes) -> (cycles_8bit, 64bit)
TABLE_II = {
    (2, 64): (25, 23), (2, 512): (55, 51), (2, 4096): (279, 275),
    (16, 64): (33, 32), (16, 512): (36, 32), (16, 4096): (64, 60),
}

# Paper headline numbers used as assertions in benches/tests
PAPER_CLAIMS = {
    "peak_util_128_matmul_2lanes": 0.985,   # ">98.5% with 2 lanes, 128²"
    "issue_rate_v10": 0.25,
    "issue_rate_v05": 0.20,
    "peak_dp_gflops_4lane": 10.4,           # Table III @1.34 GHz
    "scalar_speedup_reduction": 380,        # "up to 380×"
}
