"""KGE trainer (the port of ``repro.kge.train``, without its mesh branch).

One step: draw negatives, score positives and negatives, apply the
model's loss, backpropagate, Adam/Adagrad update, post-step constraint.
Params and optimizer state stay on the trainer's device and are updated
in place.  Scoring takes one of two paths:

* a model with a ``kge_score_model`` (TransE, DistMult) gathers the
  batch's rows once and scores positives and negatives in one fused call
  (``kernels.ops.kge_score``: the CUDA kernel on the card, its plain
  version on the CPU); the kernel's backward gives the gradients of the
  gathered rows, and autograd's gather backward scatters them into the
  tables;
* every other model (TransR, HolE, BoxE, RDF2vec) scores through its own
  ``model.score`` on the corrupted ``(h, r, t)`` ids, as the reference
  does, and autograd gives the gradients.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.triples import TripleLoader
from ..device import resolve_device
from ..kernels import ops
from ..optim import OPTIMIZERS, Optimizer, OptState
from .base import KGEModel, Params, remap_params
from .losses import get_loss
from .negatives import corrupt


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 1024
    num_negs: int = 32
    epochs: int = 100                  # paper default
    optimizer: str = "adam"
    lr: float = 1e-2
    reg_weight: float = 0.0
    seed: int = 0
    log_every: int = 50


class TrainStep(NamedTuple):
    """The step of :func:`make_train_step`, in three forms."""

    #: (params, opt_state, triples (B, 3) int64, generator) -> loss; draws
    #: the negatives from ``generator``
    step: Callable[..., torch.Tensor]
    #: (params, opt_state, triples, rand_ents (B, K), corrupt_head (B, K))
    #: -> loss, with the negatives given
    step_with: Callable[..., torch.Tensor]
    #: (params, triples, rand_ents, corrupt_head) -> (loss, {name: grad});
    #: changes nothing
    loss_and_grads: Callable[..., Tuple[torch.Tensor, Params]]


def _fused_scores(model: KGEModel):
    """(leaves, triples, rand_ents, corrupt_head) -> (pos (B,), neg (B, K))
    through ``ops.kge_score``."""
    def scores(leaves: Params, triples: torch.Tensor,
               rand_ents: torch.Tensor, corrupt_head: torch.Tensor):
        ent, rel = leaves["entity"], leaves["relation"]
        b, k = rand_ents.shape
        # one gather of every entity row the step reads: h, t, then the
        # (B, K) corrupting rows; one scatter of their gradients back
        rows = ent.index_select(0, torch.cat(
            [triples[:, 0], triples[:, 2], rand_ents.reshape(-1)]))
        h, t, neg = rows.split([b, b, b * k])
        neg = neg.view(b, k, -1)
        r = rel.index_select(0, triples[:, 1])
        return ops.kge_score(h, r, t, neg, corrupt_head,
                             model.kge_score_model)
    return scores


def _model_scores(model: KGEModel):
    """The same through ``model.score``: the negatives as the reference's
    ``corrupt`` builds them, ``(h, r, t)`` ids of shape (B, K)."""
    def scores(leaves: Params, triples: torch.Tensor,
               rand_ents: torch.Tensor, corrupt_head: torch.Tensor):
        h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
        pos = model.score(leaves, h, r, t)
        nh = torch.where(corrupt_head, rand_ents, h[:, None])
        nt = torch.where(corrupt_head, t[:, None], rand_ents)
        neg = model.score(leaves, nh, r[:, None].expand_as(rand_ents), nt)
        return pos, neg
    return scores


def make_train_step(model: KGEModel, optimizer: Optimizer,
                    cfg: TrainConfig) -> TrainStep:
    loss_fn = get_loss(model.spec.loss)
    loss_kwargs: Dict[str, Any] = {}
    if model.spec.loss in ("margin", "nssa"):
        loss_kwargs["margin"] = model.spec.margin
    scores = (_model_scores(model) if model.kge_score_model is None
              else _fused_scores(model))

    def loss_and_grads(params: Params, triples: torch.Tensor,
                       rand_ents: torch.Tensor, corrupt_head: torch.Tensor):
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pos, negs = scores(leaves, triples, rand_ents, corrupt_head)
        loss = loss_fn(pos, negs, **loss_kwargs)
        if cfg.reg_weight:
            loss = loss + cfg.reg_weight * model.regularizer(
                leaves, triples[:, 0], triples[:, 1], triples[:, 2])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        # a table the batch's loss does not reach gets a zero gradient,
        # as jax.grad gives it
        return loss.detach(), {n: torch.zeros_like(leaves[n]) if g is None
                               else g for n, g in zip(names, grads)}

    def step_with(params: Params, opt_state: OptState, triples: torch.Tensor,
                  rand_ents: torch.Tensor, corrupt_head: torch.Tensor):
        loss, grads = loss_and_grads(params, triples, rand_ents, corrupt_head)
        optimizer.update(grads, opt_state, params)
        model.constrain(params)
        return loss

    def step(params: Params, opt_state: OptState, triples: torch.Tensor,
             generator: torch.Generator):
        rand_ents, corrupt_head = corrupt(generator, triples,
                                          model.spec.n_entities, cfg.num_negs)
        return step_with(params, opt_state, triples, rand_ents, corrupt_head)

    return TrainStep(step, step_with, loss_and_grads)


class KGETrainer:
    """Drives the step over a TripleLoader on one device (default: the
    card; ``device="cpu"`` for the plain PyTorch path)."""

    def __init__(self, model: KGEModel, cfg: TrainConfig, device=None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = OPTIMIZERS[cfg.optimizer](cfg.lr)
        self.train_step = make_train_step(model, self.optimizer, cfg)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, seed: Optional[int] = None) -> Tuple[Params, OptState]:
        params = self.model.init(
            self.generator(self.cfg.seed if seed is None else seed))
        return params, self.optimizer.init(params)

    def warm_init(
        self,
        prev_params,
        entity_map: np.ndarray,
        relation_map: np.ndarray,
        seed: Optional[int] = None,
    ) -> Tuple[Params, OptState, Dict[str, int]]:
        """Init from a previous version's params remapped onto this model's
        vocabulary (see :func:`repro_torch.kge.base.remap_params`):
        surviving rows carried, new rows fresh, removed rows dropped.
        Optimizer state is fresh — the old moments index the old row space.

        Returns (params, opt_state, carry_stats).
        """
        params, stats = remap_params(
            self.model, self.generator(self.cfg.seed if seed is None else seed),
            prev_params, entity_map, relation_map)
        return params, self.optimizer.init(params), stats

    def fit(
        self,
        triples: np.ndarray,
        params: Optional[Params] = None,
        opt_state: Optional[OptState] = None,
        epochs: Optional[int] = None,
        steps: Optional[int] = None,
        log: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> Tuple[Params, OptState, Dict[str, Any]]:
        """Train for ``epochs`` (paper default 100) or an explicit ``steps``."""
        cfg = self.cfg
        if params is None:
            params, opt_state = self.init()
        elif opt_state is None:
            opt_state = self.optimizer.init(params)
        loader = TripleLoader(triples, cfg.batch_size, seed=cfg.seed)
        n_epochs = cfg.epochs if epochs is None else epochs
        total_steps = steps if steps is not None else n_epochs * max(1, loader.steps_per_epoch)

        gen = self.generator(cfg.seed + 1)
        it = iter(loader)
        losses = []
        t0 = time.perf_counter()
        for i in range(total_steps):
            batch = torch.from_numpy(next(it)).to(self.device, torch.int64)
            loss = self.train_step.step(params, opt_state, batch, gen)
            if i % cfg.log_every == 0 or i == total_steps - 1:
                l = float(loss)
                losses.append((i, l))
                if log:
                    log({"step": i, "loss": l})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        stats = {
            "steps": total_steps,
            "final_loss": losses[-1][1] if losses else float("nan"),
            "losses": losses,
            "wall_s": elapsed,
            "triples_per_s": total_steps * cfg.batch_size / max(elapsed, 1e-9),
        }
        return params, opt_state, stats
