"""Architecture registry: ``--arch <id>`` -> config + model.

Port of ``repro/models/registry.py``: every architecture the reference
registers, each family's driver (the ``LM`` over a family's layer set;
``VLM`` for vlm, ``EncDecLM`` for encdec), and the (arch x shape) grid
with each cell's inputs as meta tensors (shapes and dtypes, no storage:
the dry run's abstract inputs; the parameters as meta tensors are
``convert.abstract_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import (deepseek_coder_33b, hymba_1_5b,
                                 llama3_2_3b, llava_next_34b, mamba2_2_7b,
                                 nemotron_4_15b, qwen2_moe_a2_7b, qwen3_14b,
                                 qwen3_moe_30b_a3b, whisper_large_v3)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
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


# ---------------------------------------------------------------------------
# the shape grid (reference :115-200)
# ---------------------------------------------------------------------------

def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported?, reason-if-not) for one (arch x shape) grid cell."""
    if shape.seq_len > 32_768 and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (DESIGN.md)")
    return True, ""


def grid_cells(*, include_skips: bool = False):
    """All (arch, shape, supported, reason) cells: 32 runnable + 8
    documented skips."""
    for name in ARCH_NAMES:
        cfg = _CONFIGS[name]
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            if ok or include_skips:
                yield name, shape.name, ok, why


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def patch_embed_stub(cfg: ArchConfig, batch: int) -> torch.Tensor:
    """Stand-in for the anyres frontend's output: one tile of
    ``n_patch_tokens`` rows (reference ``vlm.patch_embed_stub``)."""
    return _meta((batch, cfg.n_patch_tokens, cfg.d_model), cfg.adtype)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The train step's batch: tokens and labels (B, S), and the encdec
    frames or the vlm patch prefix."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int64),
             "labels": _meta((b, s), torch.int64)}
    if cfg.family == "encdec":
        specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), cfg.adtype)
    if cfg.family == "vlm":
        specs["prefix_embeds"] = patch_embed_stub(cfg, b)
    return specs


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Inputs of ``prefill(params, tokens, cache, **extras)``; the cache is
    the model's own ``init_cache`` at the shape's length (plus the patch
    rows for vlm) on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg, device="meta")
    cache_len = s + (cfg.n_patch_tokens if cfg.family == "vlm" else 0)
    out = {"tokens": _meta((b, s), torch.int64),
           "cache": model.init_cache(b, cache_len)}
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), cfg.adtype)
    if cfg.family == "vlm":
        out["patch_embeds"] = patch_embed_stub(cfg, b)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Inputs of ``decode_step(params, token_t, cache, pos)`` with a cache
    of shape.seq_len rows (one new token against that context)."""
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg, device="meta")
    return {"token_t": _meta((b,), torch.int64),
            "cache": model.init_cache(b, s),
            "pos": _meta((b,), torch.int64)}


@dataclasses.dataclass(frozen=True)
class Bundle:
    name: str
    cfg: ArchConfig
    model: Any

    def input_specs(self, shape_name: str) -> dict:
        shape = SHAPES[shape_name]
        if shape.kind == "train":
            return train_batch_specs(self.cfg, shape)
        if shape.kind == "prefill":
            return prefill_specs(self.cfg, shape)
        return decode_specs(self.cfg, shape)


def build(name: str, *, reduced: bool = False, device="cuda",
          kernels=ops) -> Bundle:
    cfg = config(name)
    if reduced:
        cfg = cfg.reduced()
    return Bundle(name=name, cfg=cfg,
                  model=build_model(cfg, device=device, kernels=kernels))
