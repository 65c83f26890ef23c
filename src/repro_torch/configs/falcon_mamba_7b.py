"""falcon-mamba-7b — attention-free mamba1 SSM: 64L d4096, ssm_state=16, vocab 65024.

[arXiv:2410.05355]

The port's copy of ``repro.configs.falcon_mamba_7b``: the same values.
"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=1,
    d_ff=0, vocab=65024, attention="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
)

REDUCED = ArchConfig(
    arch_id="falcon-mamba-7b-reduced", family="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=1,
    d_ff=0, vocab=512, attention="none",
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
)
