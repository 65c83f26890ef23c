"""KGE models and their trainer: the port of ``repro.kge``, the paper's
six models (TransE, TransR, DistMult, HolE, BoxE, RDF2vec)."""
from .base import (KGEModel, KGESpec, PAPER_DIM, PAPER_EPOCHS,
                   available_models, make_model, params_from_numpy,
                   params_to_numpy, remap_params, vocab_remap)
from . import transe, transr, distmult, hole, boxe, rdf2vec  # noqa: F401 (registry)
from .eval import rank_based_eval
from .losses import LOSSES, get_loss
from .negatives import corrupt
from .train import KGETrainer, TrainConfig, TrainStep, make_train_step

__all__ = [
    "KGEModel", "KGESpec", "PAPER_DIM", "PAPER_EPOCHS",
    "available_models", "make_model", "params_from_numpy", "params_to_numpy",
    "remap_params", "vocab_remap", "rank_based_eval",
    "LOSSES", "get_loss", "corrupt",
    "KGETrainer", "TrainConfig", "TrainStep", "make_train_step",
]
