"""whisper-base — enc-dec audio backbone: 6L(x2) d512 8H ff2048 vocab 51865; conv/mel frontend stubbed.

[arXiv:2212.04356]

The port's copy of ``repro.configs.whisper_base``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    norm="layernorm", act="gelu", rope_theta=0.0,
    tie_embeddings=True, dec_len_cap=448,
    source="arXiv:2212.04356",
)

REDUCED = ArchConfig(
    arch_id="whisper-base-reduced", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512,
    norm="layernorm", act="gelu", rope_theta=0.0,
    tie_embeddings=True, dec_len_cap=32,
)
