"""qwen3-moe-30b-a3b — 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B].

head_dim=128 explicit (HF config; q-dim 4096 != d_model 2048).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,              # per-expert hidden width
    vocab=151_936,
    head_dim=128,
    act="silu_gated",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    max_seq=32_768,
)
