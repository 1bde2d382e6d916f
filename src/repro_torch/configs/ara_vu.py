"""The paper's own configuration: the Ara VU1.0 vector unit itself.

Port of ``repro/configs/ara_vu.py`` (kept as a copy: the port imports
nothing of the JAX package).  Used by the vector-unit path (fmatmul /
fconv2d / dot-product sweeps) and the core VRF/reduction modules.  Mirrors
the physical implementation of §VI.B: 4 lanes, VLEN=4096 (16 KiB VRF),
64-bit datapath per lane, and the benchmark sweep axes of Fig. 2 /
Table II.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class VectorUnitConfig:
    lanes: int = 4
    vlen_bits: int = 4096
    datapath_bytes: int = 8            # 64-bit lane datapath
    vrf_banks_per_lane: int = 8        # 8 × 1RW SRAM banks
    issue_rate: float = 0.25           # computational instr / cycle (RVV 1.0)
    issue_rate_v05: float = 0.20       # the RVV 0.5 limit (vins overhead)
    freq_ghz: float = 1.34             # TT corner
    # paper sweep axes
    bench_lane_counts: tuple = (2, 4, 8, 16)
    bench_matmul_sizes: tuple = (16, 32, 64, 128, 256)
    bench_vector_bytes: tuple = (64, 512, 4096)
    bench_eew_bytes: tuple = (1, 8)

    @property
    def vrf_bytes(self) -> int:
        return 32 * self.vlen_bits // 8

    def peak_dp_flops_per_cycle(self, lanes: int | None = None) -> int:
        """2 FLOP (FMA) per lane per cycle on 64-bit elements."""
        return 2 * (lanes or self.lanes)


CONFIG = VectorUnitConfig()
