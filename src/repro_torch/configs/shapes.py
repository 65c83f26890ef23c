"""The four assigned input shapes, and which step each lowers: the port's
copy of ``repro.configs.shapes``.

  train_4k     — train_step   (loss + grads + Adam update)
  prefill_32k  — prefill_step (build KV cache / recurrent state, last logits)
  decode_32k   — serve_step   (ONE new token against a seq_len cache)
  long_500k    — serve_step, sub-quadratic archs only (SSM / hybrid /
                 sliding-window dense); full-attention archs are skipped
                 and recorded in DESIGN.md.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: str                    # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(arch_cfg, shape: InputShape) -> bool:
    """long_500k only for sub-quadratic archs (per the assignment)."""
    if shape.name != "long_500k":
        return True
    from ..models import build
    return build(arch_cfg).supports_long_context()
