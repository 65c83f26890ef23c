"""Batch analytics workloads behind the async job subsystem.

The port of ``repro.core.analytics``: the same three workloads, the same
rows and summaries, on the engine's device (the card unless the engine
was built for the CPU).  Three long-running computations over published
snapshots, each written
as slab-iterated host loops that report progress through a ``tick``
callback between slabs — the job executor uses that boundary to publish
progress fractions, observe cancellation, and yield the process to
interactive traffic:

* :func:`bulk_knn_join` — all-pairs top-k neighbors for a submitted
  class list, batched through the block-tiled streaming kernel
  (``kernels.ops.topk_cosine_join``, the top-k kernel on the card) so
  peak device allocation stays O(query_slab · table_block + query_slab ·
  k). On the card the results are bit-identical to a serial per-query
  ``top_k`` loop (``EmbeddingIndex.knn_join_rows``).
* :func:`drift_report` — per-entity neighborhood churn (Jaccard over
  top-k neighbor-id sets) between two releases, plus a ``GraphDelta``
  summary and snapshot lineage when the parsed graphs are stored.
* :func:`model_compare` — per-model filtered-ranking metrics
  (MRR / mean rank / Hits@k as ``kge.eval`` ranks them) for one published
  version, cached in the snapshot store (``eval.json``) so repeat
  requests are free. Models whose full params are stored with a vocab
  matching the graph get the exact KGE scoring path; everything else
  (rdf2vec token vocabularies, params-less snapshots) falls back to
  cosine ranking over the *served* embedding table — tagged in the
  output so the two methods are never silently compared.

This module is core-layer: it raises plain exceptions
(:class:`UnknownClasses`, ``KeyError``, ``ValueError``) and never
imports the api package; the jobs layer maps failures to ApiError codes.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ref import no_tf32

Tick = Optional[Callable[[float], None]]


class UnknownClasses(KeyError):
    """One or more submitted class names resolve to no table row.
    Carries the *full* missing list, not just the first."""

    def __init__(self, missing: Sequence[str]):
        self.missing = list(missing)
        shown = ", ".join(repr(m) for m in self.missing[:20])
        extra = "" if len(self.missing) <= 20 else \
            f" (+{len(self.missing) - 20} more)"
        super().__init__(f"unknown class(es): {shown}{extra}")


def _tick(tick: Tick, frac: float) -> None:
    if tick is not None:
        tick(min(1.0, max(0.0, frac)))


def _resolve_all(index, classes: Sequence[str]) -> List[int]:
    rows, missing = [], []
    for c in classes:
        r = index.resolve(c)
        if r is None:
            missing.append(c)
        else:
            rows.append(r)
    if missing:
        raise UnknownClasses(missing)
    return rows


# --------------------------------------------------------------------- #
# 1. bulk kNN join
# --------------------------------------------------------------------- #
def bulk_knn_join(engine, ontology: str, model: str, classes: Sequence[str],
                  k: int = 10, version: Optional[str] = None,
                  slab: int = 256, tick: Tick = None,
                  ) -> Tuple[List[List[Any]], Dict[str, Any]]:
    """All-pairs top-``k`` join for ``classes``. Row shape:
    ``[identifier, [[neighbor_id, score], ...]]`` in submission order
    (deduplicated by resolved table row is *not* applied — one output
    row per input class)."""
    index = engine._index(ontology, model, version)
    rows = _resolve_all(index, classes)
    out: List[List[Any]] = []
    t0 = time.perf_counter()
    n_slabs = 0
    for start, hits in index.knn_join_rows(rows, k, slab=slab):
        for qi, lst in enumerate(hits):
            ident = index.entity_ids[rows[start + qi]]
            out.append([ident, [[c.identifier, c.score] for c in lst]])
        n_slabs += 1
        _tick(tick, len(out) / max(1, len(rows)))
    summary = {
        "n_queries": len(rows),
        "k": int(k),
        "table_rows": int(index.embeddings.shape[0]),
        "slabs": n_slabs,
        "compute_s": round(time.perf_counter() - t0, 4),
    }
    return out, summary


# --------------------------------------------------------------------- #
# 2. cross-version drift report
# --------------------------------------------------------------------- #
def drift_report(engine, ontology: str, model: str, version_a: str,
                 version_b: str, k: int = 10,
                 classes: Optional[Sequence[str]] = None,
                 slab: int = 256, tick: Tick = None,
                 ) -> Tuple[List[List[Any]], Dict[str, Any]]:
    """Per-entity neighborhood churn between two releases.

    For every entity published in *both* versions (or the submitted
    ``classes`` subset), computes the Jaccard overlap of its top-``k``
    neighbor-id sets under ``version_a`` (older) and ``version_b``
    (newer). Row shape: ``[identifier, jaccard]``; 1.0 = unchanged
    neighborhood, 0.0 = fully churned. The summary folds in the exact
    ``GraphDelta`` between the stored parsed releases (when present)
    and the newer snapshot's lineage sidecar."""
    idx_a = engine._index(ontology, model, version_a)
    idx_b = engine._index(ontology, model, version_b)
    ids_a = set(idx_a.entity_ids)
    if classes is None:
        common = [i for i in idx_b.entity_ids if i in ids_a]
    else:
        # submitted subset: resolve against the *newer* release, then
        # keep those that also exist in the older one
        rows_b = _resolve_all(idx_b, classes)
        common = [idx_b.entity_ids[r] for r in rows_b
                  if idx_b.entity_ids[r] in ids_a]
    out: List[List[Any]] = []
    t0 = time.perf_counter()
    jac_sum = 0.0
    for start in range(0, len(common), slab):
        chunk = common[start:start + slab]
        rows_a = [idx_a.resolve(i) for i in chunk]
        rows_b = [idx_b.resolve(i) for i in chunk]
        hits_a = idx_a.top_k_rows(rows_a, k)
        hits_b = idx_b.top_k_rows(rows_b, k)
        for ident, ha, hb in zip(chunk, hits_a, hits_b):
            sa = {c.identifier for c in ha}
            sb = {c.identifier for c in hb}
            union = len(sa | sb)
            jac = 1.0 if union == 0 else len(sa & sb) / union
            jac_sum += jac
            out.append([ident, jac])
        _tick(tick, len(out) / max(1, len(common)))
    summary: Dict[str, Any] = {
        "version_a": version_a,
        "version_b": version_b,
        "k": int(k),
        "n_common": len(common),
        "only_a": len(ids_a) - len(set(common) & ids_a)
        if classes is None else None,
        "only_b": len(idx_b.entity_ids) - len(common)
        if classes is None else None,
        "mean_jaccard": round(jac_sum / len(common), 6) if common else None,
        "compute_s": round(time.perf_counter() - t0, 4),
    }
    store = engine.registry.store
    if store.has_graph(ontology, version_a) and \
            store.has_graph(ontology, version_b):
        from ..ontology.delta import GraphDelta
        delta = GraphDelta.compute(store.load_graph(ontology, version_a),
                                   store.load_graph(ontology, version_b))
        summary["graph_delta"] = delta.stats()
    try:
        summary["lineage"] = store.load_metadata(
            ontology, version_b, model).get("lineage")
    except (OSError, ValueError):
        summary["lineage"] = None
    return out, summary


# --------------------------------------------------------------------- #
# 3. per-model comparison (/compare)
# --------------------------------------------------------------------- #
def _filtered_metrics(score_tails, score_heads, eval_triples: np.ndarray,
                      all_triples: np.ndarray, n_entities: int,
                      tick: Tick, base: float, span: float,
                      batch: int = 64) -> Dict[str, float]:
    """Chunked both-sides filtered ranking (same contract as
    ``kge.eval.rank_based_eval``), yielding through ``tick`` between
    chunks. ``score_*`` map (h, r) / (r, t) index arrays to
    (b, n_entities) score matrices."""
    from ..kge.eval import _ranks
    known_tails: Dict[tuple, set] = {}
    known_heads: Dict[tuple, set] = {}
    for h, r, t in all_triples:
        known_tails.setdefault((int(h), int(r)), set()).add(int(t))
        known_heads.setdefault((int(r), int(t)), set()).add(int(h))
    ranks = []
    m = eval_triples.shape[0]
    for start in range(0, m, batch):
        part = eval_triples[start:start + batch]
        h, r, t = part[:, 0], part[:, 1], part[:, 2]
        tail_scores = score_tails(h, r)
        mask = np.zeros((part.shape[0], n_entities), dtype=bool)
        for i, (hh, rr) in enumerate(zip(h, r)):
            for tt in known_tails.get((int(hh), int(rr)), ()):
                mask[i, tt] = True
        ranks.append(_ranks(tail_scores, t, mask))
        head_scores = score_heads(r, t)
        mask = np.zeros((part.shape[0], n_entities), dtype=bool)
        for i, (rr, tt) in enumerate(zip(r, t)):
            for hh in known_heads.get((int(rr), int(tt)), ()):
                mask[i, hh] = True
        ranks.append(_ranks(head_scores, h, mask))
        _tick(tick, base + span * min(1.0, (start + batch) / max(1, m)))
    all_ranks = np.concatenate(ranks) if ranks else np.array([1.0])
    out = {"mrr": float(np.mean(1.0 / all_ranks)),
           "mean_rank": float(np.mean(all_ranks))}
    for kk in (1, 3, 10):
        out[f"hits@{kk}"] = float(np.mean(all_ranks <= kk))
    return out


def model_compare(engine, ontology: str, version: str,
                  models: Sequence[str], sample: Optional[int] = None,
                  tick: Tick = None,
                  ) -> Tuple[List[List[Any]], Dict[str, Any]]:
    """Per-model eval metrics for one published version. Row shape:
    ``[model, metrics_dict]`` where ``metrics_dict`` carries
    mrr/mean_rank/hits@{1,3,10} plus ``method`` ("kge" exact scoring
    from stored params, "cosine" ranking over the served table),
    ``sample`` (eval triples used) and ``cached`` — or ``None`` with a
    ``note`` when the version has no stored parsed graph to rank
    against. The eval split is a seeded permutation of the release's
    triples, so every model of a version ranks the same triples and the
    stored cache stays honest."""
    store = engine.registry.store
    sample = None if sample is None else max(1, int(sample))
    out: List[List[Any]] = []
    summary: Dict[str, Any] = {"version": version, "computed": 0,
                               "cached": 0, "skipped": 0}
    if not store.has_graph(ontology, version):
        for m in models:
            out.append([m, None])
        summary["skipped"] = len(models)
        summary["note"] = (f"no parsed graph stored for "
                           f"{ontology}/{version}: nothing to rank against")
        _tick(tick, 1.0)
        return out, summary
    kg = store.load_graph(ontology, version)
    n_eval = len(kg.triples) if sample is None else min(sample,
                                                        len(kg.triples))
    perm = np.random.default_rng(0).permutation(len(kg.triples))
    eval_triples = np.asarray(kg.triples)[perm[:n_eval]]
    all_triples = np.asarray(kg.triples)
    span = 1.0 / max(1, len(models))
    for mi, m in enumerate(models):
        base = mi * span
        cached = store.has_eval(ontology, version, m)
        if cached:
            entry = store.load_eval(ontology, version, m)
            if entry.get("sample") == n_eval:
                out.append([m, {**entry["metrics"],
                                "method": entry["method"],
                                "sample": entry["sample"],
                                "cached": True}])
                summary["cached"] += 1
                _tick(tick, base + span)
                continue
        metrics, method = _eval_one(engine, store, ontology, version, m,
                                    kg, eval_triples, all_triples,
                                    tick, base, span)
        store.save_eval(ontology, version, m,
                        {"metrics": metrics, "method": method,
                         "sample": n_eval, "seed": 0})
        out.append([m, {**metrics, "method": method, "sample": n_eval,
                        "cached": False}])
        summary["computed"] += 1
        _tick(tick, base + span)
    return out, summary


def _eval_one(engine, store, ontology: str, version: str, model_name: str,
              kg, eval_triples: np.ndarray, all_triples: np.ndarray,
              tick: Tick, base: float, span: float
              ) -> Tuple[Dict[str, float], str]:
    """One model's metrics: exact KGE scoring when the stored params
    vocab matches the graph, else cosine ranking over the served table."""
    if store.has_params(ontology, version, model_name):
        try:
            params, vocab = store.load_params(ontology, version, model_name)
            if vocab.get("entity") == list(kg.entities):
                from ..kge.base import make_model, params_from_numpy
                meta = store.load_metadata(ontology, version, model_name)
                dim = int(meta.get("hyperparameters", {}).get(
                    "dim", next(iter(params.values())).shape[-1]))
                model = make_model(model_name, kg.num_entities,
                                   kg.num_relations, dim=dim)
                dev = engine.device
                tparams = params_from_numpy(model, params, dev)

                @torch.no_grad()
                def scores(score_all, a, b):
                    a, b = (torch.from_numpy(np.asarray(
                        x, dtype=np.int64)).to(dev) for x in (a, b))
                    return score_all(tparams, a, b).cpu().numpy()

                metrics = _filtered_metrics(
                    lambda h, r: scores(model.score_all_tails, h, r),
                    lambda r, t: scores(model.score_all_heads, r, t),
                    eval_triples, all_triples, kg.num_entities,
                    tick, base, span)
                return metrics, "kge"
        except (KeyError, ValueError, TypeError):
            pass  # fall through to the served-table ranking
    # cosine ranking over the served table, aligned to graph entity order
    index = engine._index(ontology, model_name, version)
    rows = [index.resolve(e) for e in kg.entities]
    if any(r is None for r in rows):
        raise ValueError(
            f"served table for {ontology}/{version}/{model_name} does not "
            f"cover the stored graph entities; cannot rank")
    dev = engine.device
    if dev.type == "cuda":
        no_tf32()
    unit = torch.from_numpy(
        index.unit_rows(np.asarray(rows, dtype=np.int64))).to(dev)

    def sims(idx_arr):
        sel = torch.from_numpy(np.asarray(idx_arr, dtype=np.int64)).to(dev)
        return torch.matmul(unit[sel], unit.T).cpu().numpy()

    metrics = _filtered_metrics(lambda h, r: sims(h), lambda r, t: sims(t),
                                eval_triples, all_triples,
                                len(kg.entities), tick, base, span)
    return metrics, "cosine"
