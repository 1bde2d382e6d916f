"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676].

3 global-attention layers (first/middle/last), sliding window 1024 for the
rest; SSM branch per layer with d_state=16.  Meta tokens are frontend-side
and out of backbone scope, as in the reference config.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    act="silu_gated",
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=16, expand=2, headdim=64, chunk=256),
    attn_window=1024,
    n_global_layers=3,
    subquadratic=True,     # SWA + 3 global layers: decode is linear in KV
    max_seq=524_288,
)
