"""KGE trainer: the port of ``repro.kge.train``.

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

On the card, ``KGETrainer.fit`` runs the fused models' step as one
captured CUDA graph (:class:`GraphedStep`), the port's counterpart of the
reference's ``jax.jit(step, donate_argnums=(0, 1))``; every other model,
and every step on the CPU, runs eagerly.

``KGETrainer(mesh=)`` is the reference's mesh branch on a process mesh
(``launch.mesh.ProcessMesh``), one rank a process.  Each table is
row-sharded over ``"model"`` (``model.param_shardings``: rows ``[m N /
M, (m + 1) N / M)`` on model rank m; a table whose rows do not divide,
such as GO's 3-row relation table, is whole on every rank).  Every rank
draws the global batch and its negatives from the same generator, so
the negatives are the single-process run's, and scores its data block of
``B / n_dp`` rows.  The step gathers every row it reads, in the order of
the single-process gather (heads, tails, the negatives' entities; the
relations), by a vocab-parallel lookup: a masked local gather and one
``all_reduce`` over ``"model"``, whose backward sends each row's
gradient into the local rows only (``models.runtime.psum_identity_bwd``).
TransE and DistMult then score through ``ops.kge_score`` (the CUDA
forward and backward kernels on the card), the others through their own
``score`` on those gathered rows, re-indexed.  Gradients are averaged
over the data axes (the losses are means over equal blocks); Adam and
``constrain`` act row by row on each rank's share.  Under a mesh the
step runs eagerly: gloo's collectives cannot be captured in a CUDA
graph, so :class:`GraphedStep` stays the single-process path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..data.triples import TripleLoader
from ..device import resolve_device
from ..kernels import ops
from ..models import runtime
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


def _lookup(table: torch.Tensor, ids: torch.Tensor, spec, mesh
            ) -> torch.Tensor:
    """Rows ``ids`` (global) of a table laid out by ``spec``: a whole
    table's own rows, or a row shard's masked local gather summed over
    ``"model"``, whose backward reaches the local rows only."""
    if spec[0] is None:
        return table.index_select(0, ids)
    return runtime.row_lookup(table, ids, mesh.group("model"))


def _gathered(model: KGEModel, mesh, specs):
    """(leaves, triples, rand_ents) -> the same three over the rows the
    batch reads: every table gathered at its ids (:func:`_lookup`), each
    entity table at ``[heads, tails, negatives]``, each relation table at
    the relations, and ids into those gathered tables."""
    roles = model.param_roles()

    def gather(leaves: Params, triples: torch.Tensor,
               rand_ents: torch.Tensor):
        b, k = rand_ents.shape
        ids = {"entity": torch.cat([triples[:, 0], triples[:, 2],
                                    rand_ents.reshape(-1)]),
               "relation": triples[:, 1]}
        rows = {n: _lookup(t, ids[roles[n]], specs[n], mesh)
                for n, t in leaves.items()}
        ar = torch.arange(b, device=triples.device)
        local = torch.stack([ar, ar, b + ar], dim=1)
        negs = 2 * b + torch.arange(b * k, device=triples.device)
        return rows, local, negs.view(b, k)
    return gather


def make_train_step(model: KGEModel, optimizer: Optimizer,
                    cfg: TrainConfig, mesh=None) -> TrainStep:
    """The step's three forms; on a process ``mesh`` the params are the
    rank's shares, the batch and negatives global (see the module)."""
    loss_fn = get_loss(model.spec.loss)
    loss_kwargs: Dict[str, Any] = {}
    if model.spec.loss in ("margin", "nssa"):
        loss_kwargs["margin"] = model.spec.margin
    scores = (_model_scores(model) if model.kge_score_model is None
              else _fused_scores(model))
    gather = dp = None
    if mesh is not None:
        gather = _gathered(model, mesh, model.param_shardings(
            "model", axis_size=mesh.shape["model"]))
        dp = runtime.data_group(mesh)
        n_dp = mesh.size // mesh.shape["model"]
        i_dp = 0 if dp is None else mesh.index(
            [a for a in mesh.axis_names if a in ("pod", "data")])

    def loss_and_grads(params: Params, triples: torch.Tensor,
                       rand_ents: torch.Tensor, corrupt_head: torch.Tensor):
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        tables = leaves
        if mesh is not None:
            b = triples.shape[0]
            if b % n_dp:
                raise ValueError(f"batch {b} does not divide into {n_dp} "
                                 f"data ranks")
            rows = slice(i_dp * (b // n_dp), (i_dp + 1) * (b // n_dp))
            triples, rand_ents, corrupt_head = (
                triples[rows], rand_ents[rows], corrupt_head[rows])
            tables, triples, rand_ents = gather(leaves, triples, rand_ents)
        pos, negs = scores(tables, triples, rand_ents, corrupt_head)
        loss = loss_fn(pos, negs, **loss_kwargs)
        if cfg.reg_weight:
            loss = loss + cfg.reg_weight * model.regularizer(
                tables, triples[:, 0], triples[:, 1], triples[:, 2])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        # a table the batch's loss does not reach gets a zero gradient,
        # as jax.grad gives it
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)}
        loss = loss.detach()
        if dp is not None:
            for g in list(grads.values()) + [loss]:
                dist.all_reduce(g, group=dp)
                g.div_(n_dp)
        return loss, grads

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


#: eager steps before a capture, on a side stream, as ``torch.cuda.graphs``
#: asks; each is a real step of the run
GRAPH_WARMUP_STEPS = 3


class GraphedStep:
    """The training step of a model with a ``kge_score_model`` (TransE,
    DistMult) in the form a CUDA graph captures, for one ``params`` and
    ``opt_state``.

    The captured part (:meth:`_body`) is the gather, ``ops.kge_score``
    forward, the loss, ``autograd.grad`` (the backward kernel and the index
    scatter-adds), Adam and ``model.constrain``.  It reads fixed tensors
    that :meth:`stage` fills before each step, in the eager step's order:
    the batch and the step's reciprocal bias corrections
    (``Optimizer.corrections``, the floats the eager step multiplies by),
    copied from pinned memory without blocking the host, then the
    negatives, drawn from the trainer's generator by the eager step's
    calls (``corrupt(..., out=)``).  The body updates through
    ``Optimizer.update_corrected``; ``opt_state.step`` stays the host's int
    and advances once a step here.  Params and moments are updated in
    place, so they are the graph's own tensors: new params need a new
    capture.

    :meth:`run` runs one step eagerly (the warm-up steps before a capture;
    the CPU tests hold it to the eager step); :meth:`capture` records the
    body once; :meth:`replay` stages a batch and replays it.  Python launch counters
    count the graph's kernels once, at the capture; ``replays`` counts the
    replays.
    """

    #: pinned host batches (and bias corrections) in turn, so the host
    #: writes one while the previous one's copy may still be queued
    HOST_SLOTS = 2

    def __init__(self, trainer: "KGETrainer", params: Params,
                 opt_state: OptState):
        cfg, dev = trainer.cfg, trainer.device
        self.model = trainer.model
        self.optimizer = trainer.optimizer
        self.loss_and_grads = trainer.train_step.loss_and_grads
        self.params, self.opt_state = params, opt_state
        self.num_negs = cfg.num_negs
        self.on_card = dev.type == "cuda"
        b, k = cfg.batch_size, cfg.num_negs
        self.batch = torch.empty((b, 3), dtype=torch.int64, device=dev)
        self.draws = (torch.empty((b, k), dtype=torch.int64, device=dev),
                      torch.empty((b, k), dtype=torch.float32, device=dev),
                      torch.empty((b, k), dtype=torch.bool, device=dev))
        n_bc = len(self.optimizer.corrections(1))
        self.corrections = torch.empty(n_bc, dtype=torch.float64, device=dev)
        self._host = [(torch.empty((b, 3), dtype=torch.int64,
                                   pin_memory=self.on_card),
                       torch.empty(n_bc, dtype=torch.float64,
                                   pin_memory=self.on_card))
                      for _ in range(self.HOST_SLOTS)]
        self._copied = [None] * self.HOST_SLOTS
        self._slot = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.loss: Optional[torch.Tensor] = None
        self.replays = 0

    def stage(self, batch: np.ndarray, generator: torch.Generator) -> None:
        """Upload ``batch`` (B, 3) and the next step's bias corrections into
        their fixed tensors and draw the batch's negatives into the fixed
        draw tensors, on the current stream."""
        slot = self._slot
        self._slot = (slot + 1) % self.HOST_SLOTS
        host, host_bc = self._host[slot]
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()   # its last copy has read it
        np.copyto(host.numpy(), batch, casting="safe")
        host_bc.numpy()[:] = self.optimizer.corrections(
            self.opt_state.step + 1)
        self.batch.copy_(host, non_blocking=True)
        self.corrections.copy_(host_bc, non_blocking=True)
        if self.on_card:
            if self._copied[slot] is None:
                self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()
        corrupt(generator, self.batch, self.model.spec.n_entities,
                self.num_negs, out=self.draws)

    def _body(self) -> torch.Tensor:
        rand_ents, _, corrupt_head = self.draws
        loss, grads = self.loss_and_grads(self.params, self.batch, rand_ents,
                                          corrupt_head)
        self.optimizer.update_corrected(grads, self.opt_state, self.params,
                                        self.corrections)
        self.model.constrain(self.params)
        return loss

    def run(self, batch: np.ndarray, generator: torch.Generator
            ) -> torch.Tensor:
        """One step, eagerly; returns its loss."""
        self.stage(batch, generator)
        loss = self._body()
        self.opt_state.step += 1
        return loss

    def warm_up(self, batches: Iterator[np.ndarray],
                generator: torch.Generator, steps: int
                ) -> List[torch.Tensor]:
        """``steps`` eager steps on a side stream, as a capture needs them
        first; returns their losses."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            losses = [self.run(next(batches), generator)
                      for _ in range(steps)]
        main.wait_stream(side)
        return losses

    def capture(self) -> None:
        """Record the body as one CUDA graph; raises if the capture fails.
        Warm-up steps (:meth:`warm_up`) come first."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.loss = self._body()
        self.graph = graph

    def replay(self, batch: np.ndarray, generator: torch.Generator
               ) -> torch.Tensor:
        """One step through the captured graph; returns the graph's loss
        tensor, which holds this step's loss until the next replay."""
        self.stage(batch, generator)
        self.graph.replay()
        self.opt_state.step += 1
        self.replays += 1
        return self.loss


class KGETrainer:
    """Drives the step over a TripleLoader on one device (default: the
    card; ``device="cpu"`` for the plain PyTorch path), or, with ``mesh``
    (a ``ProcessMesh``), as one rank of a mesh on ``mesh.device``: its
    params and optimizer state are then the rank's shares
    (:meth:`shard` / :meth:`gather`)."""

    def __init__(self, model: KGEModel, cfg: TrainConfig, device=None,
                 mesh=None):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
            self.specs = model.param_shardings(
                "model", axis_size=mesh.shape["model"])
            bad = [n for n, r in model.param_roles().items() if r is None]
            if bad:
                raise ValueError(f"tables {bad} index neither entities nor "
                                 f"relations: no row to look up")
        self.device = resolve_device(device)
        self.optimizer = OPTIMIZERS[cfg.optimizer](cfg.lr)
        self.train_step = make_train_step(model, self.optimizer, cfg, mesh)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def shard(self, params: Params) -> Params:
        """This rank's shares of full ``params`` (itself without a mesh)."""
        if self.mesh is None:
            return params
        return {n: runtime.take_share(t.to(self.device), self.specs[n],
                                      self.mesh)
                for n, t in params.items()}

    def gather(self, params: Params) -> Params:
        """Full params from every rank's shares (collective over the
        mesh's world; itself without a mesh)."""
        if self.mesh is None:
            return params
        return {n: runtime.gather_share(t, self.specs[n], self.mesh)
                for n, t in params.items()}

    def init(self, seed: Optional[int] = None) -> Tuple[Params, OptState]:
        params = self.shard(self.model.init(
            self.generator(self.cfg.seed if seed is None else seed)))
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
        params = self.shard(params)
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
        """Train for ``epochs`` (paper default 100) or an explicit ``steps``.

        On the card a model with a ``kge_score_model`` trains through one
        :class:`GraphedStep` captured for this call: the first
        ``GRAPH_WARMUP_STEPS`` steps run eagerly on a side stream, the rest
        replay the graph (``stats["graph_replays"]``); every step counts in
        ``steps``.  A failed capture raises.  On a mesh every step runs
        eagerly and the losses are the global batch's."""
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

        def logged(i: int, loss: torch.Tensor) -> None:
            if i % cfg.log_every == 0 or i == total_steps - 1:
                l = float(loss)
                losses.append((i, l))
                if log:
                    log({"step": i, "loss": l})

        t0 = time.perf_counter()
        graphed = None
        if (self.device.type == "cuda" and self.model.kge_score_model
                and self.mesh is None):
            graphed = GraphedStep(self, params, opt_state)
            warm = min(total_steps, GRAPH_WARMUP_STEPS)
            with torch.cuda.device(self.device):
                for i, loss in enumerate(graphed.warm_up(it, gen, warm)):
                    logged(i, loss)
                if total_steps > warm:
                    graphed.capture()
                for i in range(warm, total_steps):
                    logged(i, graphed.replay(next(it), gen))
        else:
            for i in range(total_steps):
                batch = torch.from_numpy(next(it)).to(self.device, torch.int64)
                logged(i, self.train_step.step(params, opt_state, batch, gen))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        stats = {
            "steps": total_steps,
            "final_loss": losses[-1][1] if losses else float("nan"),
            "losses": losses,
            "wall_s": elapsed,
            "triples_per_s": total_steps * cfg.batch_size / max(elapsed, 1e-9),
            "graph_replays": graphed.replays if graphed else 0,
        }
        return params, opt_state, stats
