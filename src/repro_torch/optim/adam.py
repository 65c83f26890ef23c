"""Adam and Adagrad over dicts of tensors, with the formulas of
``repro.optim.adam``.

The update is dense over whole tables, as the reference's is: a row the
batch did not touch has a zero gradient, yet its Adam moments still decay
and the row still moves.  ``torch.optim.SparseAdam`` or sparse gradients
would give a different result, not a faster one.  Unlike the reference,
which returns new pytrees, ``update`` writes the params and the state in
place (under ``torch.no_grad``), so a step allocates no second copy of
the tables.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LR = Union[float, Callable[[int], float]]


@dataclasses.dataclass
class OptState:
    step: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def adam(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW. ``lr`` may be a float or a schedule fn(step)->lr."""

    def init(params: Params) -> OptState:
        return OptState(0, _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        state.step += 1
        step = state.step
        lr_t = lr(step) if callable(lr) else lr
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        for name, p in params.items():
            g = grads[name]
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            # p - lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
            denom = (nu / bc2).sqrt_().add_(eps)
            d = (mu / bc1).div_(denom)
            if weight_decay:
                d.add_(p, alpha=weight_decay)
            p.sub_(d, alpha=lr_t)
        return params, state

    return Optimizer(init, update)


def adagrad(lr: float = 0.5, eps: float = 1e-10) -> Optimizer:
    """Adagrad — the classic choice for sparse embedding training."""

    def init(params: Params) -> OptState:
        acc = _zeros(params)
        return OptState(0, acc, acc)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        for name, p in params.items():
            g = grads[name]
            acc = state.mu[name]
            acc.addcmul_(g, g)
            p.sub_(g * lr / (acc.sqrt() + eps))
        state.step += 1
        return params, state

    return Optimizer(init, update)


OPTIMIZERS = {"adam": adam, "adagrad": adagrad}
