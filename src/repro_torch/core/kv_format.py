"""KV-cache storage formats (port of ``repro/core/kv_format.py``).

A :class:`KVFormat` names how K/V rows live in the slot-major arena:

  * ``fp32`` -- ``store_dtype=None``: the model's activation dtype, so a
    bf16 model's default arena stays bf16 and runs the unscaled kernels;
  * ``bf16`` -- half the resident bytes of an f32 arena, no scales;
  * ``int8`` -- a quarter of f32's bytes plus a per-row, per-KV-head f32
    absmax scale (``k_scale`` / ``v_scale`` leaves beside ``k`` / ``v``),
    dequantized inside flash_decode and flash_prefill_chunk;
  * ``fp8`` -- e4m3 storage (``torch.float8_e4m3fn``) with the same scales
    and 448 (e4m3's largest finite value) as qmax; registered only where
    torch has the dtype and converts to it.

Rows are produced in compute precision and quantized once, where they are
written into the arena; every read widens them in registers.
:func:`quantize` equals the reference's bit for bit: an f32 divide by the
scale, round half to even (int8), clamp, cast.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["KVFormat", "get", "names", "bytes_per_row", "quantize",
           "dequantize", "SCALE_DTYPE"]

#: the scale leaves' dtype: f32, never the storage dtype
SCALE_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class KVFormat:
    """One arena storage format.  ``store_dtype`` None: the model's
    activation dtype."""
    name: str
    store_dtype: Optional[torch.dtype]
    scaled: bool = False        # carries k_scale / v_scale leaves
    qmax: float = 0.0           # absmax maps to +-qmax (scaled formats)

    def resolve_dtype(self, adtype: torch.dtype) -> torch.dtype:
        return adtype if self.store_dtype is None else self.store_dtype

    def store_bytes(self, adtype: torch.dtype) -> int:
        return self.resolve_dtype(adtype).itemsize


_REGISTRY: dict[str, KVFormat] = {}


def _register(fmt: KVFormat) -> KVFormat:
    _REGISTRY[fmt.name] = fmt
    return fmt


FP32 = _register(KVFormat("fp32", None))
BF16 = _register(KVFormat("bf16", torch.bfloat16))
INT8 = _register(KVFormat("int8", torch.int8, scaled=True, qmax=127.0))


def _fp8_supported() -> bool:
    """The dtype exists and a conversion to it runs."""
    dt = getattr(torch, "float8_e4m3fn", None)
    if dt is None:
        return False
    try:
        torch.zeros(1).to(dt)
        return True
    except (RuntimeError, TypeError):
        return False


if _fp8_supported():
    _register(KVFormat("fp8", torch.float8_e4m3fn, scaled=True, qmax=448.0))


def names() -> tuple[str, ...]:
    """Every registered format name (fp8 only where it converts)."""
    return tuple(_REGISTRY)


def get(name: str) -> KVFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kv_format {name!r}; available: {sorted(_REGISTRY)}"
            + ("" if "fp8" in _REGISTRY else
               " (fp8 requires a torch with float8_e4m3fn)")) from None


def bytes_per_row(fmt: KVFormat, n_kv_heads: int, head_dim: int,
                  adtype: torch.dtype = torch.float32) -> int:
    """Resident arena bytes of one token row of one layer: K + V + the
    scales (int8 at KVH 8, hd 128: 2 * 8 * 128 + 2 * 8 * 4 = 2112)."""
    store = 2 * n_kv_heads * head_dim * fmt.store_bytes(adtype)
    scale = 2 * n_kv_heads * SCALE_DTYPE.itemsize if fmt.scaled else 0
    return store + scale


def quantize(fmt: KVFormat, x: torch.Tensor):
    """Rows ``x`` (..., KVH, hd) in the format's storage dtype.  Returns
    ``(q, scale)``: ``scale`` (..., KVH) f32 for a scaled format (absmax /
    qmax, 1.0 for an all-zero row, so a row never written dequantizes to
    exact zeros), None otherwise.  Makes no host read."""
    if not fmt.scaled:
        return (x if fmt.store_dtype is None
                else x.to(fmt.store_dtype)), None
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / fmt.qmax, 1.0).to(SCALE_DTYPE)
    y = x32 / scale[..., None]
    if fmt.store_dtype == torch.int8:
        q = torch.clamp(torch.round(y), -fmt.qmax, fmt.qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -fmt.qmax, fmt.qmax).to(fmt.store_dtype)
    return q, scale


def dequantize(fmt: KVFormat, q: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stored rows widened to f32 (times their scale, if any): the plain
    form of what the kernels do in registers."""
    del fmt
    wide = q.float()
    return wide if scale is None else wide * scale.float()[..., None]
