"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*2560 = 5120, headdim 64 -> 80 SSM heads, d_state 128.
n_heads/n_kv_heads are the SSM head count (no attention anywhere).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,            # SSM heads = d_inner / headdim
    n_kv_heads=80,
    d_ff=0,                # attention-free, FFN-free pure SSD stack
    vocab=50_280,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, chunk=256),
    subquadratic=True,
    max_seq=524_288,
)
