"""Step factories for serving: prefill and greedy decode.  The port of the
serving part of ``repro.models.steps`` (``make_train_step`` waits for the
training slice).  The params live in the model, so the steps take none."""
from __future__ import annotations

from typing import Callable

import torch

from .lm import BaseLM


def make_prefill_step(model: BaseLM) -> Callable:
    """step(batch, cache_len=None) -> (last logits (B, 1, V), cache)."""
    def step(batch, cache_len=None):
        return model.prefill(batch, cache_len=cache_len)
    return step


def make_serve_step(model: BaseLM) -> Callable:
    """ONE new token against an existing cache. Greedy-samples so the
    output is a token, not raw logits: step(cache, token (B, 1), pos) ->
    (next_token (B, 1) int32, cache)."""
    def step(cache, token: torch.Tensor, pos: int):
        logits, cache = model.decode_step(cache, token, pos)
        return logits.argmax(-1).to(torch.int32), cache
    return step
