"""Lane-split Vector Register File byte-layout model (paper §IV.A-D).

Port of ``repro/core/vrf.py`` on ``torch.uint8`` tensors.  Ara (VU1.0)
splits the VRF across lanes: consecutive *elements* map to consecutive
lanes (element ``i`` lives in lane ``i % lanes``), while RVV 1.0 mandates
SLEN == VLEN, i.e. the *memory image* of a register is the plain
little-endian concatenation of its elements.  The byte<->lane mapping
therefore depends on the effective element width (EEW) a register was
written with:

  * ``shuffle``    — memory byte image  -> lane-organised VRF bytes
  * ``deshuffle``  — lane-organised VRF bytes -> memory byte image
                     (requires the EEW the register was written with)
  * ``reshuffle``  — deshuffle(old EEW) . shuffle(new EEW); injected by the
                     front-end whenever an instruction writes a register with
                     a different EEW without fully overwriting it.

``VectorRegisterFile`` reproduces the paper's reshuffle-injection logic and
counts injections (the IPC-loss mechanism of §IV.D.2).  Everything here is
plain PyTorch on the device of the tensors it is given; the register file
is made on ``cuda`` unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import device as device_mod

VALID_EEW = (1, 2, 4, 8)  # element widths in *bytes* (SEW 8/16/32/64 bit)


def _check(vlenb: int, eew: int, lanes: int) -> None:
    if eew not in VALID_EEW:
        raise ValueError(f"EEW must be one of {VALID_EEW} bytes, got {eew}")
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"lane count must be a power of two, got {lanes}")
    n_elems = vlenb // eew
    if vlenb % eew:
        raise ValueError(f"VLENB {vlenb} not a multiple of EEW {eew}")
    if n_elems % lanes:
        raise ValueError(
            f"{n_elems} elements of width {eew}B do not divide over {lanes} "
            f"lanes")


def shuffle(mem_bytes: torch.Tensor, *, eew: int, lanes: int) -> torch.Tensor:
    """Memory byte image ``(VLENB,)`` -> lane view ``(lanes, VLENB // lanes)``.

    Element ``i`` (bytes ``[i*eew, (i+1)*eew)`` of the memory image) is placed
    in lane ``i % lanes`` at slot ``i // lanes`` (paper §IV.B).
    """
    vlenb = mem_bytes.shape[-1]
    _check(vlenb, eew, lanes)
    slots = vlenb // eew // lanes
    lead = mem_bytes.shape[:-1]
    x = mem_bytes.reshape(*lead, slots, lanes, eew)       # [slot, lane, byte]
    x = x.transpose(-3, -2)                               # [lane, slot, byte]
    return x.reshape(*lead, lanes, slots * eew)


def deshuffle(lane_bytes: torch.Tensor, *, eew: int,
              lanes: int) -> torch.Tensor:
    """Lane view ``(lanes, VLENB // lanes)`` -> memory byte image ``(VLENB,)``.

    ``eew`` must be the EEW the register was *written* with; any other value
    models exactly the corruption the paper describes (§IV.D.2).
    """
    lanes_in, per_lane = lane_bytes.shape[-2], lane_bytes.shape[-1]
    vlenb = lanes_in * per_lane
    if lanes_in != lanes:
        raise ValueError(f"lane view has {lanes_in} lanes, expected {lanes}")
    _check(vlenb, eew, lanes)
    slots = vlenb // eew // lanes
    lead = lane_bytes.shape[:-2]
    x = lane_bytes.reshape(*lead, lanes, slots, eew)      # [lane, slot, byte]
    x = x.transpose(-3, -2)                               # [slot, lane, byte]
    return x.reshape(*lead, vlenb)


def reshuffle(lane_bytes: torch.Tensor, *, old_eew: int, new_eew: int,
              lanes: int) -> torch.Tensor:
    """Re-encode a register's lane layout from ``old_eew`` to ``new_eew``
    (the slide unit's null-stride vslide); the memory image is invariant."""
    return shuffle(deshuffle(lane_bytes, eew=old_eew, lanes=lanes),
                   eew=new_eew, lanes=lanes)


def write_register(old_lane_bytes: torch.Tensor, old_eew_is_new: bool,
                   new_mem_bytes: torch.Tensor, vl, *, eew: int, lanes: int,
                   tail_policy: str = "undisturbed") -> torch.Tensor:
    """Write the first ``vl`` elements (EEW ``eew``) into a register.

    ``old_lane_bytes`` must already be encoded with EEW ``eew`` (the caller —
    ``VectorRegisterFile`` — injects a reshuffle first if it was not).

    tail_policy:
      * ``"undisturbed"`` — tail bytes keep their old value (RVV `tu`).
      * ``"agnostic_ones"`` — tail bytes are overwritten with 0xFF (RVV `ta`).
    """
    del old_eew_is_new  # bookkeeping lives in VectorRegisterFile
    vlenb = new_mem_bytes.shape[-1]
    _check(vlenb, eew, lanes)
    byte_idx = torch.arange(vlenb, device=new_mem_bytes.device)
    active = byte_idx < vl * eew                      # body bytes
    new_lane = shuffle(new_mem_bytes, eew=eew, lanes=lanes)
    active_lane = shuffle(active.to(torch.uint8), eew=eew, lanes=lanes) > 0
    if tail_policy == "undisturbed":
        tail_val = old_lane_bytes
    elif tail_policy == "agnostic_ones":
        tail_val = torch.full_like(old_lane_bytes, 0xFF)
    else:
        raise ValueError(f"unknown tail policy {tail_policy!r}")
    return torch.where(active_lane, new_lane, tail_val)


@dataclasses.dataclass
class RegState:
    eew: int          # EEW the register is currently encoded with (bytes)
    known: bool = True


class VectorRegisterFile:
    """Bookkeeping model of the 32-register lane-split VRF (paper §IV.D.2).

    Tracks the EEW each register was last written with and injects a
    reshuffle before any partial write with a different EEW.  ``stats``
    counts injected reshuffles and moved bytes.
    """

    NUM_REGS = 32

    def __init__(self, *, vlen_bits: int = 4096, lanes: int = 4,
                 default_eew: int = 1, device="cuda"):
        if vlen_bits % 8:
            raise ValueError("VLEN must be a multiple of 8 bits")
        self.vlenb = vlen_bits // 8
        self.lanes = lanes
        dev = device_mod.resolve(device)
        self.regs = [
            torch.zeros((lanes, self.vlenb // lanes), dtype=torch.uint8,
                        device=dev)
            for _ in range(self.NUM_REGS)
        ]
        self.state = [RegState(default_eew) for _ in range(self.NUM_REGS)]
        self.stats = {"reshuffles": 0, "reshuffled_bytes": 0, "writes": 0}

    # -- architectural accessors ------------------------------------------
    def read_mem_image(self, reg: int) -> torch.Tensor:
        """Architectural (memory-layout) value of a register."""
        st = self.state[reg]
        return deshuffle(self.regs[reg], eew=st.eew, lanes=self.lanes)

    def write(self, reg: int, mem_bytes: torch.Tensor, *, eew: int,
              vl: int | None = None, tail_policy: str = "undisturbed") -> None:
        """Architectural write of ``vl`` elements at ``eew``; injects a
        reshuffle when the register's EEW differs and the write is partial
        (the paper skips injection for full overwrites)."""
        max_vl = self.vlenb // eew
        vl = max_vl if vl is None else vl
        full_overwrite = vl >= max_vl
        st = self.state[reg]
        if st.eew != eew and not full_overwrite:
            self.regs[reg] = reshuffle(self.regs[reg], old_eew=st.eew,
                                       new_eew=eew, lanes=self.lanes)
            self.stats["reshuffles"] += 1
            self.stats["reshuffled_bytes"] += self.vlenb
        self.regs[reg] = write_register(
            self.regs[reg], True, mem_bytes, vl, eew=eew, lanes=self.lanes,
            tail_policy=tail_policy)
        self.state[reg] = RegState(eew)
        self.stats["writes"] += 1

    # -- element views -----------------------------------------------------
    def elements(self, reg: int, dtype=torch.uint8) -> torch.Tensor:
        """Architectural elements of ``reg`` viewed as ``dtype``
        (little-endian, as ``lax.bitcast_convert_type``)."""
        return self.read_mem_image(reg).contiguous().view(dtype).reshape(-1)
