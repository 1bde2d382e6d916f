"""Architecture registry: ``--arch <id>`` -> config + model.

Port of ``repro/models/registry.py`` for the dense family.  The other
families of the reference raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import (deepseek_coder_33b, llama3_2_3b,
                                 nemotron_4_15b, qwen3_14b)
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

_CONFIGS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_coder_33b, nemotron_4_15b, qwen3_14b, llama3_2_3b)
}

ARCH_NAMES: tuple[str, ...] = tuple(sorted(_CONFIGS))

# the reference's non-dense architectures and the ROADMAP item porting them
_NOT_PORTED = {
    "hymba-1.5b": "hybrid", "llava-next-34b": "vlm",
    "mamba2-2.7b": "ssm", "qwen2-moe-a2.7b": "moe",
    "qwen3-moe-30b-a3b": "moe", "whisper-large-v3": "encdec",
}


def config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is family {_NOT_PORTED[name]!r}, not ported yet "
            f"(ROADMAP Open items 1.8)")
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}") from None


def build_model(cfg: ArchConfig, *, device="cuda", kernels=ops):
    """The family driver for a config (full or reduced)."""
    if cfg.family == "dense":
        return T.LM(cfg, device=device, kernels=kernels)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Open items 1.8)")


@dataclasses.dataclass(frozen=True)
class Bundle:
    name: str
    cfg: ArchConfig
    model: Any


def build(name: str, *, reduced: bool = False, device="cuda",
          kernels=ops) -> Bundle:
    cfg = config(name)
    if reduced:
        cfg = cfg.reduced()
    return Bundle(name=name, cfg=cfg,
                  model=build_model(cfg, device=device, kernels=kernels))
