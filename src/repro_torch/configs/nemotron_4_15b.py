"""nemotron-4-15b — dense, GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256_000,
    act="relu2",           # squared ReLU, ungated
    rope_theta=10_000.0,
    max_seq=32_768,
)
