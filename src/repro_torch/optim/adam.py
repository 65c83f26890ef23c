"""Adam, Adagrad and SGD over dicts of tensors, with the formulas of
``repro.optim.adam``.

The update is dense over whole tables, as the reference's is: a row the
batch did not touch has a zero gradient, yet its Adam moments still decay
and the row still moves.  ``torch.optim.SparseAdam`` or sparse gradients
would give a different result, not a faster one.  Unlike the reference,
which returns new pytrees, ``update`` writes the params and the state in
place (under ``torch.no_grad``), so a step allocates no second copy of
the tables.

``update_corrected`` is the same update for a step captured in a CUDA
graph: it reads Adam's bias corrections from a tensor on the device, which
the caller fills before each replay with ``corrections(step)`` (a capture
would freeze the Python floats of its first step), and leaves
``state.step`` to the caller.  Both forms multiply by the corrections'
reciprocals, computed on the host: on the card, dividing by a Python float
multiplies by its float32 reciprocal while dividing by a tensor divides,
and the last bits that differ are enough for TransE's training to drift
(a product is the same either way).
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
    #: (grads, state, params) -> (params, state): advances ``state.step``
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    #: step -> the reciprocal bias corrections ``update`` applies at that
    #: step, as floats (none for an optimizer without them)
    corrections: Callable[[int], Tuple[float, ...]]
    #: (grads, state, params, corrections) -> None: the same update with
    #: the bias corrections read from ``corrections``, a float64 tensor on
    #: the params' device holding ``corrections(state.step + 1)``;
    #: ``state.step`` is not touched
    update_corrected: Callable[[Params, OptState, Params, torch.Tensor],
                               None]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def adam(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW. ``lr`` may be a float or a schedule fn(step)->lr."""

    def init(params: Params) -> OptState:
        return OptState(0, _zeros(params), _zeros(params))

    def corrections(step: int) -> Tuple[float, float]:
        return 1 / (1 - b1 ** step), 1 / (1 - b2 ** step)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        state.step += 1
        step = state.step
        lr_t = lr(step) if callable(lr) else lr
        _apply(grads, state, params, lr_t, *corrections(step))
        return params, state

    @torch.no_grad()
    def update_corrected(grads: Params, state: OptState, params: Params,
                         bc: torch.Tensor) -> None:
        if callable(lr):
            raise ValueError("update_corrected needs a constant lr")
        _apply(grads, state, params, lr, bc[0], bc[1])

    def _apply(grads: Params, state: OptState, params: Params, lr_t: float,
               inv_bc1, inv_bc2) -> None:
        """The update with reciprocal bias corrections ``inv_bc1``,
        ``inv_bc2``: floats, or 0-dim float64 tensors holding the same
        floats (the same products)."""
        for name, p in params.items():
            g = grads[name]
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            # p - lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
            denom = (nu * inv_bc2).sqrt_().add_(eps)
            d = (mu * inv_bc1).div_(denom)
            if weight_decay:
                d.add_(p, alpha=weight_decay)
            p.sub_(d, alpha=lr_t)

    return Optimizer(init, update, corrections, update_corrected)


def adagrad(lr: float = 0.5, eps: float = 1e-10) -> Optimizer:
    """Adagrad — the classic choice for sparse embedding training."""

    def init(params: Params) -> OptState:
        acc = _zeros(params)
        return OptState(0, acc, acc)

    def corrections(step: int) -> Tuple[float, ...]:
        return ()

    @torch.no_grad()
    def update_corrected(grads: Params, state: OptState, params: Params,
                         bc=None) -> None:
        # Adagrad's update does not depend on the step
        for name, p in params.items():
            g = grads[name]
            acc = state.mu[name]
            acc.addcmul_(g, g)
            p.sub_(g * lr / (acc.sqrt() + eps))

    def update(grads: Params, state: OptState, params: Params):
        update_corrected(grads, state, params)
        state.step += 1
        return params, state

    return Optimizer(init, update, corrections, update_corrected)


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum when ``momentum`` is not 0: ``mu =
    momentum * mu + g`` and ``p -= lr * mu``; without it ``p -= lr * g``
    and ``state.mu`` holds a copy of the last gradients (the reference's
    ``mu = grads``).  ``state.nu`` stays the zeros ``init`` made, as the
    reference carries them."""

    def init(params: Params) -> OptState:
        return OptState(0, _zeros(params), _zeros(params))

    def corrections(step: int) -> Tuple[float, ...]:
        return ()

    @torch.no_grad()
    def update_corrected(grads: Params, state: OptState, params: Params,
                         bc=None) -> None:
        # SGD's update does not depend on the step
        for name, p in params.items():
            mu = state.mu[name]
            if momentum:
                mu.mul_(momentum).add_(grads[name])
            else:
                mu.copy_(grads[name])
            p.sub_(mu * lr)

    def update(grads: Params, state: OptState, params: Params):
        update_corrected(grads, state, params)
        state.step += 1
        return params, state

    return Optimizer(init, update, corrections, update_corrected)


OPTIMIZERS = {"adam": adam, "adagrad": adagrad, "sgd": sgd}
