"""The LM zoo on PyTorch: the port of ``repro.models`` for the dense, MoE,
SSM, hybrid, audio and VLM families (configs, layers, attention, blocks,
``BaseLM``, ``DenseLM``, ``MoELM``, ``MambaLM``, ``HybridLM``,
``EncDecModel``, ``VLM``, the zoo, the serving steps and the carry-over
of the JAX package's params)."""
from .config import ArchConfig, HybridConfig, MoEConfig, SSMConfig
from .zoo import ARCH_IDS, FAMILIES, build, get_config, get_model, normalize_arch_id

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "HybridConfig",
    "ARCH_IDS", "FAMILIES", "build", "get_config", "get_model",
    "normalize_arch_id",
]
