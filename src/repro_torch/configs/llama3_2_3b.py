"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2 family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128_256,
    act="silu_gated",
    rope_theta=500_000.0,
    max_seq=32_768,
)
