"""mistral-large-123b — dense: 88L d12288 96H kv8 ff28672 vocab 32768.

[hf:mistralai/Mistral-Large-Instruct-2407]

The port's copy of ``repro.configs.mistral_large_123b``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768, rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

REDUCED = ArchConfig(
    arch_id="mistral-large-123b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512,
)
