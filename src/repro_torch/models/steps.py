"""Step factories: train, prefill and greedy decode.  The port of
``repro.models.steps`` (its dry-run specs wait for the dry run, ROADMAP
Queue 1).  The params live in the model, so the steps take none."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..optim import Optimizer, OptState, adam
from .lm import BaseLM


def make_train_step(model: BaseLM, lr: float = 3e-4
                    ) -> Tuple[Callable, Optimizer]:
    """Returns (step, optimizer).  ``step(opt_state, batch) -> (opt_state,
    metrics)``: the loss and its gradients (``loss.backward()``), then
    Adam, in place, over ``dict(model.params.named_parameters())`` (the
    dict ``optimizer.init`` takes); ``metrics`` are the loss's with
    ``loss``.  Turns the params' gradients on."""
    optimizer = adam(lr)
    params = dict(model._p().requires_grad_(True).named_parameters())

    def step(opt_state: OptState, batch):
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        optimizer.update(grads, opt_state, params)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss.detach())

    return step, optimizer


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
