"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window attention: 24L d2560 32H kv8 ff6912 vocab 32000.

[arXiv:2401.16818]

The port's copy of ``repro.configs.h2o_danube_1_8b``: the same values.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    attention="sliding_window", window=4096,
    source="arXiv:2401.16818",
)

REDUCED = ArchConfig(
    arch_id="h2o-danube-1.8b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512,
    attention="sliding_window", window=64,
)
