"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,          # GQA kv=8 (assignment spec)
    d_ff=19200,
    vocab=32256,
    act="silu_gated",
    rope_theta=100_000.0,
    max_seq=32_768,
)
