"""Model registry: family -> class, arch-id -> (config, model).  The port of
``repro.models.zoo`` for the families ported so far: all but the hybrid
(recurrentgemma)."""
from __future__ import annotations

import importlib
from typing import Tuple

from .config import ArchConfig
from .dense import DenseLM
from .encdec import EncDecModel
from .lm import BaseLM
from .moe import MoELM
from .ssm import MambaLM
from .vlm import VLM

FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
    "ssm": MambaLM,
    "audio": EncDecModel,
    "vlm": VLM,
}

#: the zoo's archs whose configs the port carries: dense, MoE, SSM, audio
#: and VLM
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
)

#: the reference zoo's other archs, by family: not ported yet
UNPORTED = {
    "recurrentgemma_2b": "hybrid",
}

_LATER = ("is not ported yet: it waits for ROADMAP Queue 2 item 4 (the SWA "
          "kernels at head dim 256), then Queue 1 item 5(f) (recurrentgemma)")


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
