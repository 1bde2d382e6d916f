"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking for
``cuda`` where no card is present raises instead of carrying on on the CPU.
``meta`` (shapes and dtypes, no storage) is what the dry run traces a
full-size model on (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
