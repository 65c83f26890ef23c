"""llava-next-34b — VLM: 60L d7168 56H (GQA kv=8) ff20480 vocab 64000, anyres tiling.

[hf:llava-hf/llava-v1.6-mistral-7b-hf scaled to the 34B variant (Nous-Hermes-2-Yi-34B backbone)]

The port's copy of ``repro.configs.llava_next_34b``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, rope_theta=5_000_000.0,
    n_frontend_tokens=2880,   # anyres: (1 base + 4 sub-tiles) * 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

REDUCED = ArchConfig(
    arch_id="llava-next-34b-reduced", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, n_frontend_tokens=16,
)
