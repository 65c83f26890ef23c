"""internlm2-20b — dense GQA: 48L d6144 48H kv8 ff16384 vocab 92544.

[arXiv:2403.17297]

The port's copy of ``repro.configs.internlm2_20b``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
)

REDUCED = ArchConfig(
    arch_id="internlm2-20b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512,
)
