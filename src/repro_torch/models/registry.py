"""Architecture registry: ``--arch <id>`` -> config + model.

Port of ``repro/models/registry.py``: every architecture the reference
registers, each family's driver (the ``LM`` over a family's layer set;
``VLM`` for vlm, ``EncDecLM`` for encdec).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import (deepseek_coder_33b, hymba_1_5b,
                                 llama3_2_3b, llava_next_34b, mamba2_2_7b,
                                 nemotron_4_15b, qwen2_moe_a2_7b, qwen3_14b,
                                 qwen3_moe_30b_a3b, whisper_large_v3)
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import hybrid as H
from repro_torch.models import mamba2 as S
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.vlm import VLM

_CONFIGS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_coder_33b, nemotron_4_15b, qwen3_14b, llama3_2_3b,
              hymba_1_5b, llava_next_34b, mamba2_2_7b, whisper_large_v3,
              qwen3_moe_30b_a3b, qwen2_moe_a2_7b)
}

#: family -> its layer set behind the LM driver
_LAYER_SETS = {"dense": T.DENSE, "moe": M.MOE, "ssm": S.SSM,
               "hybrid": H.HYBRID}

ARCH_NAMES: tuple[str, ...] = tuple(sorted(_CONFIGS))


def config(name: str) -> ArchConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}") from None


def build_model(cfg: ArchConfig, *, device="cuda", kernels=ops):
    """The family driver for a config (full or reduced)."""
    if cfg.family == "vlm":
        return VLM(cfg, T.DENSE, device=device, kernels=kernels)
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device, kernels=kernels)
    layers = _LAYER_SETS.get(cfg.family)
    if layers is not None:
        return T.LM(cfg, layers, device=device, kernels=kernels)
    raise ValueError(f"unknown family {cfg.family!r}")


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
