"""qwen2-72b — dense GQA with QKV bias: 80L d8192 64H kv8 ff29568 vocab 152064.

[arXiv:2407.10671]

The port's copy of ``repro.configs.qwen2_72b``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)

REDUCED = ArchConfig(
    arch_id="qwen2-72b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, qkv_bias=True,
)
