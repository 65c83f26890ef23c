"""recurrentgemma-2b — Griffin hybrid (RG-LRU : local attention 1:2): 26L d2560 10H (MQA kv=1) ff7680 vocab 256000.

[arXiv:2402.19427]

The port's copy of ``repro.configs.recurrentgemma_2b``: the same values.
"""
from ..models.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, act="gelu",
    hybrid=HybridConfig(pattern=("recurrent", "recurrent", "attention"),
                        lru_width=2560, conv_width=4, window=2048),
    source="arXiv:2402.19427",
)

REDUCED = ArchConfig(
    arch_id="recurrentgemma-2b-reduced", family="hybrid",
    n_layers=5, d_model=256, n_heads=2, n_kv_heads=1,
    d_ff=512, vocab=512, act="gelu",
    hybrid=HybridConfig(pattern=("recurrent", "recurrent", "attention"),
                        lru_width=256, conv_width=4, window=64),
)
