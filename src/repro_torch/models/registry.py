"""Architecture registry: ``--arch <id>`` -> config + model.

Port of ``repro/models/registry.py`` for the dense, ssm and hybrid
families.  The other families of the reference raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import (deepseek_coder_33b, hymba_1_5b,
                                 llama3_2_3b, mamba2_2_7b, nemotron_4_15b,
                                 qwen3_14b)
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import hybrid as H
from repro_torch.models import mamba2 as S
from repro_torch.models import transformer as T

_CONFIGS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_coder_33b, nemotron_4_15b, qwen3_14b, llama3_2_3b,
              mamba2_2_7b, hymba_1_5b)
}

#: family -> its layer set behind the LM driver
_LAYER_SETS = {"dense": T.DENSE, "ssm": S.SSM, "hybrid": H.HYBRID}

ARCH_NAMES: tuple[str, ...] = tuple(sorted(_CONFIGS))

# the reference's architectures not ported yet and the ROADMAP item for each
_NOT_PORTED = {
    "llava-next-34b": "vlm", "qwen2-moe-a2.7b": "moe",
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
    layers = _LAYER_SETS.get(cfg.family)
    if layers is not None:
        return T.LM(cfg, layers, device=device, kernels=kernels)
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
