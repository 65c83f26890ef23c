"""Where the port runs: one explicit ``torch.device`` per entry point.

Every entry point of the port (``EmbeddingIndex``, ``ServingEngine``,
``launch.serve``, ``launch.train``, ``launch.generate``,
``models.convert.params_from_numpy``) takes its device from
:func:`resolve_device`.  The
default is the card; the CPU is used only when a caller asks for it, and
then the plain PyTorch version of every kernel runs.  Nothing falls back
to the CPU on its own: a missing card is an error, never a slow answer.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` when a CUDA device
    is asked for (explicitly or by default) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev

