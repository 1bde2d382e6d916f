"""llava-next-34b — VLM backbone; anyres tiling is frontend-side (stub).

Precomputed patch embeddings (576 tokens per tile, one tile) are
prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64_000,
    act="silu_gated",
    rope_theta=5_000_000.0,
    n_patch_tokens=576,
    max_seq=32_768,
)
