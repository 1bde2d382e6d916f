"""Architecture configuration dataclasses (torch counterpart of
``repro.configs.base``).

``ArchConfig`` keeps every field of the JAX package's dataclass, so a config
can be converted field by field between the two; only ``pdtype``/``adtype``
differ, returning torch dtypes.  ``reduced()`` derives the smoke-test scale
variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0          # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default: d_model // n_heads
    act: str = "silu_gated"             # silu_gated | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_window: Optional[int] = None
    n_global_layers: int = 0
    n_enc_layers: int = 0
    enc_seq: int = 1500
    n_patch_tokens: int = 0
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    subquadratic: bool = False
    max_seq: int = 32_768

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.act_dtype]

    def n_params(self) -> int:
        """Total parameter count (embedding included), by the reference's
        formula (configs/base.py:90).  For encdec the formula counts the
        decoder's learned positions as ``enc_seq`` rows, where the tree
        holds ``max_seq`` of them (whisper-large-v3: 1.603 B here, 1.643 B
        in the tree); ported as it is."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.qk_norm:
            attn += 2 * hd
        mlp = (3 if self.act == "silu_gated" else 2) * d * self.d_ff
        if self.moe:
            # the routed experts, the shared ones with their gate, the
            # router (reference :101-110)
            me = self.moe
            mlp = 3 * d * me.d_ff_expert * me.n_experts + d * me.n_experts
            if me.n_shared_experts:
                mlp += 3 * d * me.d_ff_shared + d
        if self.ssm is not None:
            s = self.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            gn = s.n_groups * s.d_state
            ssm_p = (d * (2 * di + 2 * gn + nh)           # in projections
                     + s.conv_width * (di + 2 * gn)       # depthwise conv
                     + 2 * nh + nh                        # A_log, dt_bias, D
                     + di + di * d)                       # norm + out
        if self.family == "ssm":
            per_layer = ssm_p + 2 * d                     # + lns
        elif self.family == "hybrid":
            # both branches, their two output norms and ln1 / ln2
            per_layer = attn + ssm_p + mlp + 3 * d
        else:
            per_layer = attn + mlp + 2 * d
        total = self.n_layers * per_layer
        total += self.vocab * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab * d                  # lm head
        total += d                                   # final norm
        if self.family == "encdec":
            # encoder layers, each decoder layer's cross-attention and
            # extra norm, the encoder positions (reference :131-136)
            enc_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
            enc_layer = enc_attn + mlp + 2 * d
            total += self.n_enc_layers * enc_layer + self.n_layers * attn \
                + self.n_layers * d + self.enc_seq * d
        return int(total)

    def n_active_params(self) -> int:
        """Parameters touched per token (reference :140): a moe config's
        top-k routed experts, its shared experts and gate, and its router
        in place of all its experts; every other family's n_params."""
        if not self.moe:
            return self.n_params()
        me, d = self.moe, self.d_model
        base = dataclasses.replace(self, moe=None, d_ff=0).n_params()
        active = 3 * d * me.d_ff_expert * me.top_k + d * me.n_experts
        if me.n_shared_experts:
            active += 3 * d * me.d_ff_shared + d
        return int(base + self.n_layers * active)

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale config of the same family (reference
        configs/base.py:150)."""
        kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=256, head_dim=16, max_seq=128)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=32,
                d_ff_shared=64 if self.moe.n_shared_experts else 0,
                n_shared_experts=min(self.moe.n_shared_experts, 2))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8, headdim=16,
                                            chunk=16)
            if self.family == "ssm":
                kw["n_heads"] = 8      # d_inner(64)=128 / headdim 16
                kw["n_kv_heads"] = 8
        if self.family == "hybrid":
            kw["attn_window"] = 32
            kw["n_global_layers"] = 1
        if self.family == "encdec":
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 24
        if self.family == "vlm":
            kw["n_patch_tokens"] = 12
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One batch shape (reference ``configs/base.py:223``): the training
    pipeline's sequence length and global batch."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


#: the (arch x shape) grid's four shapes (reference ``configs/base.py:230``)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
