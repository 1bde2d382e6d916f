"""qwen2-moe-a2.7b — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA
    d_ff=1408,             # per-expert hidden width
    vocab=151_936,
    act="silu_gated",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=5632),
    max_seq=32_768,
)
