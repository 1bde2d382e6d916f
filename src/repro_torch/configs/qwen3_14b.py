"""qwen3-14b — dense, qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151_936,
    act="silu_gated",
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq=32_768,
)
