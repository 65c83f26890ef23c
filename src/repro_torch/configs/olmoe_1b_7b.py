"""olmoe-1b-7b — MoE: 16L d2048 16H kv16 ff1024/expert, 64 experts top-8, vocab 50304.

[arXiv:2409.02060]

The port's copy of ``repro.configs.olmoe_1b_7b``: the same values.
"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, capacity_factor=1.25),
    source="arXiv:2409.02060",
)

REDUCED = ArchConfig(
    arch_id="olmoe-1b-7b-reduced", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25),
)
