"""whisper-large-v3 — enc-dec audio backbone [arXiv:2212.04356].

The conv frontend is a stub: precomputed frame embeddings (enc_seq=1500,
d_model) enter the encoder.  32 encoder + 32 decoder layers; MHA (kv=20
== n_heads).  The real model caps decoder positions at 448; the config
keeps the reference's max_seq.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,           # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    act="gelu",
    enc_seq=1500,
    max_seq=32_768,
)
