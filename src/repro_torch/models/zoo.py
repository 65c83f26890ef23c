"""Model registry: family -> class, arch-id -> (config, model).  The port of
``repro.models.zoo`` for the families ported so far."""
from __future__ import annotations

import importlib
from typing import Tuple

from .config import ArchConfig
from .dense import DenseLM
from .lm import BaseLM
from .moe import MoELM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
}

#: the zoo's dense and MoE archs, whose configs the port carries
ARCH_IDS = (
    "h2o_danube_1_8b",
    "mistral_large_123b",
    "qwen2_72b",
    "internlm2_20b",
    "olmoe_1b_7b",
    "grok_1_314b",
)

#: the reference zoo's other archs, by family: not ported yet
UNPORTED = {
    "llava_next_34b": "vlm",
    "falcon_mamba_7b": "ssm",
    "whisper_base": "audio",
    "recurrentgemma_2b": "hybrid",
}

_LATER = ("is not ported yet: it arrives with ROADMAP Queue 1's slice of the "
          "other zoo families (Mamba, audio, VLM, recurrentgemma)")


def normalize_arch_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    name = normalize_arch_id(arch)
    if name in UNPORTED:
        raise NotImplementedError(
            f"{arch} (family {UNPORTED[name]!r}) {_LATER}")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.CONFIG


def build(cfg: ArchConfig) -> BaseLM:
    """The model for ``cfg``, without params (``init`` or
    ``convert.params_from_numpy`` gives it some)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} {_LATER}")
    return FAMILIES[cfg.family](cfg)


def get_model(arch: str, reduced: bool = False) -> Tuple[ArchConfig, BaseLM]:
    cfg = get_config(arch, reduced)
    return cfg, build(cfg)
