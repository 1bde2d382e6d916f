"""Mask Unit: RVV 1.0 predication over a lane-split VRF (paper §IV.D.1, §V.d).

Port of ``repro/core/masking.py``.  RVV 1.0 packs mask bits densely — bit
``i`` of the mask lives at bit ``i % 8`` of byte ``i // 8`` of the mask
register's *memory image* — and any vector register may act as the mask
register.  With a lane-split VRF the Mask Unit must deshuffle the mask
register with its recorded EEW, unpack the dense bit layout, and
re-distribute bit ``i`` to the lane that owns element ``i`` (lane
``i % lanes``, slot ``i // lanes``): ``mask_unit``.  ``apply_mask`` /
``predicated`` are the element-level semantics (masked-off elements keep
the old destination value — RVV `mu`).

Integer promotion differs from JAX's: shifting and summing ``uint8`` in
torch gives int64 where JAX gives uint32; the results are cast back to
``uint8`` as the reference does, so the bytes are the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import vrf


def unpack_bits(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    """LSB-first bit unpack of a uint8 byte image -> bool ``(num_bits,)``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :num_bits].to(torch.bool)


def pack_bits(bits: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse of :func:`unpack_bits` (pads to a byte boundary with zeros)."""
    pad = (-num_bits) % 8
    b = F.pad(bits.to(torch.uint8), (0, pad))
    b = b.reshape(*bits.shape[:-1], -1, 8)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    return (b * weights).sum(-1).to(torch.uint8)


def mask_unit(mask_reg_lane_bytes: torch.Tensor, *, stored_eew: int,
              lanes: int, num_elems: int) -> torch.Tensor:
    """Fetch + deshuffle + unpack + distribute mask bits to lanes.

    Returns a boolean ``(lanes, num_elems // lanes)`` predicate array:
    ``out[l, s]`` is the mask bit of element ``i = s * lanes + l``.
    """
    if num_elems % lanes:
        raise ValueError(f"{num_elems} elements not divisible by {lanes} "
                         f"lanes")
    mem = vrf.deshuffle(mask_reg_lane_bytes, eew=stored_eew, lanes=lanes)
    bits = unpack_bits(mem, num_elems)                     # element order
    return bits.reshape(num_elems // lanes, lanes).T       # -> (lanes, slots)


def apply_mask(dest_old: torch.Tensor, computed: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """RVV mask-undisturbed write: keep old destination where mask is 0."""
    return torch.where(mask, computed, dest_old)


def tail_mask(n: int, vl) -> torch.Tensor:
    """Body predicate for a strip-mined chunk: True for the first ``vl``
    (on ``vl``'s device when it is a tensor)."""
    dev = vl.device if isinstance(vl, torch.Tensor) else None
    return torch.arange(n, device=dev) < vl


def predicated(fn):
    """Wrap an elementwise op so masked-off lanes keep the destination value.

    ``predicated(fn)(dest, *args, mask=m)`` == where(m, fn(*args), dest).
    """
    def wrapped(dest_old, *args, mask):
        return apply_mask(dest_old, fn(*args), mask)
    return wrapped
