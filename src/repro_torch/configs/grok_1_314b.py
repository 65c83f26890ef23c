"""grok-1-314b — MoE: 64L d6144 48H kv8 ff32768/expert, 8 experts top-2, vocab 131072.

[hf:xai-org/grok-1]

The port's copy of ``repro.configs.grok_1_314b``: the same values.  At
~633 GB in bf16 it does not fit one card: on the card it runs at full
width, cut in depth.
"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    source="hf:xai-org/grok-1",
)

REDUCED = ArchConfig(
    arch_id="grok-1-314b-reduced", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25),
)
