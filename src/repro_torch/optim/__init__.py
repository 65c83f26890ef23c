"""Optimizers of the update path (the port of ``repro.optim``)."""
from .adam import OPTIMIZERS, Optimizer, OptState, adagrad, adam, sgd
from .schedules import constant, inverse_sqrt, linear_warmup_cosine

__all__ = [
    "OPTIMIZERS", "Optimizer", "OptState", "adagrad", "adam", "sgd",
    "constant", "inverse_sqrt", "linear_warmup_cosine",
]
