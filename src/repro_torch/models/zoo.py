"""Model registry: family -> class, arch-id -> (config, model).  The port of
``repro.models.zoo``: every family and every arch of the reference's
zoo."""
from __future__ import annotations

import importlib
from typing import Tuple

from .config import ArchConfig
from .dense import DenseLM
from .encdec import EncDecModel
from .hybrid import HybridLM
from .lm import BaseLM
from .moe import MoELM
from .ssm import MambaLM
from .vlm import VLM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
    "ssm": MambaLM,
    "hybrid": HybridLM,
    "audio": EncDecModel,
    "vlm": VLM,
}

#: the zoo's archs: the reference's ``ARCH_IDS``, in the order the port
#: took them
ARCH_IDS = (
    "h2o_danube_1_8b",
    "mistral_large_123b",
    "qwen2_72b",
    "internlm2_20b",
    "olmoe_1b_7b",
    "grok_1_314b",
    "falcon_mamba_7b",
    "whisper_base",
    "llava_next_34b",
    "recurrentgemma_2b",
)


def normalize_arch_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    name = normalize_arch_id(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.CONFIG


def build(cfg: ArchConfig) -> BaseLM:
    """The model for ``cfg``, without params (``init`` or
    ``convert.params_from_numpy`` gives it some)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: the zoo has "
                                  f"{tuple(FAMILIES)}")
    return FAMILIES[cfg.family](cfg)


def get_model(arch: str, reduced: bool = False) -> Tuple[ArchConfig, BaseLM]:
    cfg = get_config(arch, reduced)
    return cfg, build(cfg)
