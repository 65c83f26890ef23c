"""The update pipeline — the paper's core freshness mechanism.

  "an automated update mechanism that periodically downloads ontology
   releases from predefined URLs, computes checksums, and compares them with
   those of previously stored versions. If a change is detected, all
   embeddings are recomputed and made available."

Offline adaptation: a *release channel* is any callable returning the latest
(version_tag, KnowledgeGraph). ``FileReleaseChannel`` polls a directory of
OBO files (what the cron job's download step would produce);
``SyntheticReleaseChannel`` wraps the synthetic evolution generator for
tests/examples.

Delta-aware staging — consecutive ontology releases overlap almost
entirely, so "recompute everything" wastes nearly all of its work. The
pipeline is explicit:

  checksum → delta → policy → train → publish → seal → invalidate

``Updater.plan`` diffs the new release against the persisted parent graph
(``GraphDelta``) and picks a mode: **full** when there is no warm-startable
parent or the ``churn_fraction`` is at/above ``churn_threshold``,
**incremental** otherwise. Incremental training remaps the parent version's
full params onto the new vocabulary (surviving rows carried, new rows fresh,
removed rows dropped) and runs with a reduced step budget (``warm_frac``).
Every publish persists full params + the parsed graph + lineage metadata,
so warm-starting works across process restarts — and across packages:
the store is the JAX package's format, so either package warm-starts from
a version the other published.

The port of ``repro.core.updater``.  Training runs on the updater's
device (default: the card) through the port's KGE trainer; the params
stay there and become numpy only at publish.  It trains the paper's six
models; RDF2vec trains on skip-gram pairs of a random-walk corpus drawn
on the same device.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import version_sort_key
from ..data.walks import corpus, skipgram_pairs, token_vocab
from ..device import resolve_device
from ..kge import (KGETrainer, TrainConfig, available_models, make_model,
                   params_to_numpy, vocab_remap, PAPER_DIM, PAPER_EPOCHS)
from ..ontology import GraphDelta, KnowledgeGraph, load_obo
from .registry import EmbeddingRegistry
from .serving import ServingEngine

#: the paper's six models
PAPER_MODELS = ("transe", "transr", "distmult", "hole", "boxe", "rdf2vec")


class ReleaseChannel:
    """Abstract release source: returns (version_tag, graph) of the latest."""

    name: str

    def latest(self) -> Tuple[str, KnowledgeGraph]:
        raise NotImplementedError


class FileReleaseChannel(ReleaseChannel):
    """Polls a directory of ``<version>.obo`` files — the on-disk mirror of
    GO's https://release.geneontology.org/ channel."""

    def __init__(self, name: str, directory: str | Path):
        self.name = name
        self.directory = Path(directory)

    def latest(self) -> Tuple[str, KnowledgeGraph]:
        # natural/date-aware ordering: '2024-10' is newer than '2024-9',
        # which plain lexicographic sort gets backwards
        releases = sorted(self.directory.glob("*.obo"),
                          key=lambda p: version_sort_key(p.stem))
        if not releases:
            raise FileNotFoundError(f"no releases in {self.directory}")
        path = releases[-1]
        return path.stem, load_obo(path)


class SyntheticReleaseChannel(ReleaseChannel):
    """In-memory channel over synthetic (version, graph) releases — what
    the evolution generator produces for tests, examples and benchmarks.
    ``bump`` publishes the next release to pollers."""

    def __init__(self, name: str, version: Optional[str] = None,
                 kg: Optional[KnowledgeGraph] = None):
        self.name = name
        self._version = version
        self._kg = kg

    def bump(self, version: str, kg: KnowledgeGraph) -> None:
        self._version, self._kg = version, kg

    def latest(self) -> Tuple[str, KnowledgeGraph]:
        if self._kg is None:
            raise LookupError(f"channel {self.name!r} has no release yet")
        return self._version, self._kg


@dataclasses.dataclass
class UpdatePlan:
    """The staged decision for one polling round, before any training."""

    ontology: str
    version: str
    checksum: str
    changed: bool
    mode: str                              # "noop" | "full" | "incremental"
    parent_version: Optional[str] = None
    delta: Optional[GraphDelta] = None
    reason: str = ""


@dataclasses.dataclass
class UpdateReport:
    ontology: str
    version: str
    checksum: str
    changed: bool
    trained_models: List[str]
    wall_s: float
    details: Dict[str, Any]
    mode: str = "noop"
    parent_version: Optional[str] = None
    delta: Optional[Dict[str, Any]] = None
    reason: str = ""


class Updater:
    """checksum → delta → policy → train → publish → seal → invalidate."""

    def __init__(
        self,
        registry: EmbeddingRegistry,
        engine: Optional[ServingEngine] = None,
        models: Sequence[str] = PAPER_MODELS,
        dim: int = PAPER_DIM,
        train_cfg: Optional[TrainConfig] = None,
        steps_override: Optional[int] = None,   # tests/examples: cap work
        walks_per_entity: int = 10,
        walk_length: int = 4,
        churn_threshold: float = 0.25,
        warm_frac: float = 0.3,
        device=None,
    ):
        for m in models:
            if m not in available_models():
                raise KeyError(f"unknown KGE model {m!r}; have "
                               f"{list(available_models())}")
        self.registry = registry
        self.engine = engine
        self.models = tuple(models)
        self.dim = dim
        self.train_cfg = train_cfg or TrainConfig(epochs=PAPER_EPOCHS)
        self.steps_override = steps_override
        self.walks_per_entity = walks_per_entity
        self.walk_length = walk_length
        #: go incremental only below this GraphDelta.churn_fraction;
        #: churn_threshold=0.0 disables warm starts entirely
        self.churn_threshold = churn_threshold
        #: incremental step/epoch budget as a fraction of the full budget
        self.warm_frac = warm_frac
        #: where every model trains
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ #
    def check(self, channel: ReleaseChannel) -> Tuple[bool, str, str, KnowledgeGraph]:
        """Returns (changed, version, checksum, graph)."""
        version, kg = channel.latest()
        checksum = kg.checksum()
        published = self.registry.published_checksum(channel.name)
        return checksum != published, version, checksum, kg

    def plan(self, channel: ReleaseChannel) -> Tuple[UpdatePlan, KnowledgeGraph]:
        """Stages checksum → delta → policy; no training happens here."""
        changed, version, checksum, kg = self.check(channel)
        ont = channel.name
        if not changed:
            return UpdatePlan(ont, version, checksum, False, "noop",
                              reason="checksum unchanged"), kg
        parent = self.registry.store.latest_version(ont)
        if parent is None:
            return UpdatePlan(ont, version, checksum, True, "full",
                              reason="no parent version"), kg
        if not self.registry.store.has_graph(ont, parent):
            return UpdatePlan(ont, version, checksum, True, "full", parent,
                              reason="parent graph not persisted"), kg
        prev_kg = self.registry.store.load_graph(ont, parent)
        delta = GraphDelta.compute(prev_kg, kg)
        churn = delta.churn_fraction
        if churn >= self.churn_threshold:
            mode = "full"
            reason = f"churn {churn:.4f} >= threshold {self.churn_threshold}"
        else:
            mode = "incremental"
            reason = f"churn {churn:.4f} < threshold {self.churn_threshold}"
        return UpdatePlan(ont, version, checksum, True, mode, parent, delta,
                          reason), kg

    # ------------------------------------------------------------------ #
    def run_once(self, channel: ReleaseChannel, seed: int = 0) -> UpdateReport:
        t0 = time.perf_counter()
        plan, kg = self.plan(channel)
        if not plan.changed:
            # report the real check/parse cost so poll-loop monitoring sees
            # what an unchanged poll actually spends
            return UpdateReport(plan.ontology, plan.version, plan.checksum,
                                False, [], time.perf_counter() - t0,
                                {}, mode="noop", reason=plan.reason)

        delta_stats = plan.delta.stats() if plan.delta is not None else None
        lineage = {"parent_version": plan.parent_version, "mode": plan.mode,
                   "delta": delta_stats}
        details: Dict[str, Any] = {}   # strictly per-model entries
        trained: List[str] = []
        labels = [kg.label_of(e) for e in kg.entities]
        for model_name in self.models:
            emb, stats, hypers, params, vocab = self._train_one(
                model_name, kg, seed, plan)
            self.registry.publish(
                channel.name, plan.version, model_name,
                kg.entities, labels, emb,
                ontology_checksum=plan.checksum,
                hyperparameters=hypers,
                train_stats={k: v for k, v in stats.items() if k != "losses"},
                params=params,
                params_vocab=vocab,
                lineage={**lineage, "mode": stats["mode"]},
            )
            trained.append(model_name)
            details[model_name] = {
                "final_loss": stats.get("final_loss"),
                "triples_per_s": stats.get("triples_per_s"),
                "wall_s": stats.get("wall_s"),
                "steps": stats.get("steps"),
                # steps replayed from the captured CUDA graph (TransE and
                # DistMult on the card; 0 elsewhere)
                "graph_replays": stats.get("graph_replays", 0),
                "mode": stats["mode"],
                "budget_frac": stats["budget_frac"],
                "step_budget_ratio": stats["step_budget_ratio"],
                "carried_rows": stats.get("carried_rows"),
                # (step, loss) every cfg.log_every steps: the curve, not
                # only its end
                "losses": stats["losses"],
            }
        # persist the parsed release so the *next* update can diff against
        # it (exact GraphDelta) even after a process restart
        self.registry.store.save_graph(channel.name, plan.version, kg)
        # seal AFTER every model is on disk: cross-process snapshot
        # watchers adopt a version only once it is sealed, so a multi-model
        # publish never becomes visible half-written
        self.registry.seal(channel.name, plan.version)
        if self.engine is not None:
            # atomic latest-pointer swap: in-flight queries pinned to the
            # old version finish consistently; new queries see `version`
            self.engine.invalidate(channel.name, plan.version)
        return UpdateReport(channel.name, plan.version, plan.checksum, True,
                            trained, time.perf_counter() - t0, details,
                            mode=plan.mode, parent_version=plan.parent_version,
                            delta=delta_stats, reason=plan.reason)

    # ------------------------------------------------------------------ #
    def _budget(self, budget_frac: float) -> Tuple[Optional[int], Optional[int]]:
        """(steps, epochs) for one training run at ``budget_frac``."""
        if self.steps_override is not None:
            return max(1, int(round(self.steps_override * budget_frac))), None
        if budget_frac >= 1.0:
            return None, None              # trainer default: cfg.epochs
        return None, max(1, int(round(self.train_cfg.epochs * budget_frac)))

    def _warm_start(self, trainer: KGETrainer, model_name: str,
                    plan: UpdatePlan, new_entity_vocab: Sequence[str],
                    new_relation_vocab: Sequence[str], seed: int):
        """(params, opt_state, carried_rows) from the parent snapshot, or
        None when the parent has no warm-startable params."""
        try:
            prev_params, prev_vocab = self.registry.get_params(
                plan.ontology, model_name, plan.parent_version)
        except KeyError:
            return None
        e_map = vocab_remap(prev_vocab.get("entity", []), new_entity_vocab)
        r_map = vocab_remap(prev_vocab.get("relation", []), new_relation_vocab)
        params, opt_state, carry = trainer.warm_init(
            prev_params, e_map, r_map, seed)
        if carry["tables_carried"] == 0:
            return None                    # nothing survived (e.g. dim change)
        return params, opt_state, carry

    def _train_one(self, model_name: str, kg: KnowledgeGraph, seed: int,
                   plan: UpdatePlan):
        cfg = dataclasses.replace(self.train_cfg, seed=seed)
        hypers = {"dim": self.dim, "epochs": cfg.epochs, "optimizer": cfg.optimizer,
                  "lr": cfg.lr, "batch_size": cfg.batch_size, "num_negs": cfg.num_negs}
        if model_name == "rdf2vec":
            walks, vocab_size, pad = corpus(
                kg, torch.Generator(device=self.device).manual_seed(seed),
                walks_per_entity=self.walks_per_entity,
                walk_length=self.walk_length)
            pairs = skipgram_pairs(walks, window=2, pad_token=pad, seed=seed)
            trips = np.stack(
                [pairs[:, 0], np.zeros(len(pairs), dtype=np.int32),
                 pairs[:, 1]], axis=1)
            model = make_model("rdf2vec", vocab_size, 1, dim=self.dim)
            # warm-start vocabulary = walk tokens (entities + relation
            # tokens + pad), matched by name across versions
            entity_vocab: List[str] = token_vocab(kg)
            relation_vocab: List[str] = []
            hypers.update({"walks_per_entity": self.walks_per_entity,
                           "walk_length": self.walk_length, "window": 2})
        else:
            trips = kg.triples
            model = make_model(model_name, kg.num_entities, kg.num_relations,
                               dim=self.dim)
            entity_vocab = list(kg.entities)
            relation_vocab = list(kg.relations)

        trainer = KGETrainer(model, cfg, device=self.device)
        warm = None
        if plan.mode == "incremental":
            warm = self._warm_start(trainer, model_name, plan,
                                    entity_vocab, relation_vocab, seed)
        budget_frac = self.warm_frac if warm is not None else 1.0
        steps, epochs = self._budget(budget_frac)
        if warm is not None:
            params0, opt_state0, carry = warm
            params, _, stats = trainer.fit(trips, params=params0,
                                           opt_state=opt_state0,
                                           epochs=epochs, steps=steps)
            stats["mode"] = "incremental"
            stats["carried_rows"] = carry["entity_carried"]
        else:
            params, _, stats = trainer.fit(trips, epochs=epochs,
                                           steps=steps)
            stats["mode"] = "full"
            stats["carried_rows"] = 0
        stats["budget_frac"] = budget_frac
        # nominal compute reduction (full steps / steps run) — NOT measured
        # wall-clock speedup
        stats["step_budget_ratio"] = round(1.0 / max(budget_frac, 1e-9), 3)

        # the only copies to the host: the served table (rdf2vec: the
        # graph entities' rows of its token table) and the params
        emb = model.entity_embeddings(params)[:kg.num_entities].detach()
        emb = emb.cpu().numpy()
        params_np = params_to_numpy(params)
        vocab = {"entity": entity_vocab, "relation": relation_vocab}
        return emb, stats, hypers, params_np, vocab


def poll_loop(
    updater: Updater,
    channels: Sequence[ReleaseChannel],
    iterations: int,
    on_report: Optional[Callable[[UpdateReport], None]] = None,
    base_seed: int = 0,
) -> List[UpdateReport]:
    """The cron-job equivalent: N polling rounds over all channels.

    Each round trains with its own seed (``base_seed + round``) — a fixed
    seed would make every retraining round draw identical walks/negatives.
    """
    reports = []
    for it in range(iterations):
        for ch in channels:
            rep = updater.run_once(ch, seed=base_seed + it)
            reports.append(rep)
            if on_report:
                on_report(rep)
    return reports
