"""Versioned embedding registry — the publication side of Bio-KGvec2go.

Wraps the SnapshotStore with the paper's semantics:
  * embeddings are keyed (ontology, version, model);
  * each snapshot carries the entity-id list, labels, PROV metadata and the
    source ontology checksum;
  * ``latest`` resolves to the most recent version (the similarity / top-k
    endpoints always serve the latest, per the paper);
  * ``to_json`` reproduces the *download* endpoint payload: one JSON object
    mapping each class to its 200-dim float array.

The port's copy of ``repro.core.registry``: the same arrays published
with the same ``generated_at`` give byte-identical store files.
"""
# bioan: module-scope[BIO002]
from __future__ import annotations

import datetime as _dt
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint import SnapshotStore
from .provenance import prov_record, validate_prov


class EmbeddingRegistry:
    def __init__(self, root: str | Path):
        self.store = SnapshotStore(root)

    # ---------------------------- publish ------------------------------ #
    def publish(
        self,
        ontology: str,
        version: str,
        model_name: str,
        entity_ids: Sequence[str],
        labels: Sequence[str],
        embeddings: np.ndarray,
        ontology_checksum: str,
        hyperparameters: Dict[str, Any],
        train_stats: Optional[Dict[str, Any]] = None,
        generated_at: Optional[str] = None,
        params: Optional[Dict[str, np.ndarray]] = None,
        params_vocab: Optional[Dict[str, Sequence[str]]] = None,
        lineage: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Publish one (ontology, version, model) snapshot.

        ``params``/``params_vocab`` (optional) persist the full model param
        pytree plus its row-name vocabularies so the *next* release can
        warm-start from this one, even across a process restart.
        ``lineage`` (optional) records how this snapshot was produced:
        ``{"parent_version", "mode", "delta": {...}}``.
        """
        assert embeddings.ndim == 2 and embeddings.shape[0] == len(entity_ids)
        generated_at = generated_at or _dt.datetime.now(_dt.timezone.utc).isoformat()
        prov = prov_record(
            ontology, version, ontology_checksum, model_name,
            hyperparameters, generated_at, train_stats,
        )
        meta = {
            "ontology": ontology,
            "version": version,
            "model": model_name,
            "dim": int(embeddings.shape[1]),
            "num_entities": int(embeddings.shape[0]),
            "ontology_checksum": ontology_checksum,
            "generated_at": generated_at,
            "prov": prov,
        }
        if lineage is not None:
            meta["lineage"] = lineage
        arrays = {
            "embeddings": np.asarray(embeddings, dtype=np.float32),
            "entity_ids": np.asarray(entity_ids, dtype=np.str_),
            "labels": np.asarray(labels, dtype=np.str_),
        }
        self.store.save(ontology, version, model_name, arrays, meta)
        if params is not None:
            self.store.save_params(ontology, version, model_name,
                                   {k: np.asarray(v) for k, v in params.items()},
                                   {k: list(v) for k, v in (params_vocab or {}).items()})

    # ----------------------------- read -------------------------------- #
    def get(
        self, ontology: str, model_name: str, version: Optional[str] = None
    ) -> Tuple[List[str], List[str], np.ndarray, Dict[str, Any]]:
        """Returns (entity_ids, labels, embeddings, metadata)."""
        version = version or self.store.latest_version(ontology)
        if version is None:
            raise KeyError(f"no published versions for ontology {ontology!r}")
        arrays, meta = self.store.load(ontology, version, model_name)
        if not validate_prov(meta.get("prov", {})):
            raise ValueError(f"corrupt PROV metadata for {ontology}/{version}/{model_name}")
        return (
            [str(x) for x in arrays["entity_ids"]],
            [str(x) for x in arrays["labels"]],
            arrays["embeddings"],
            meta,
        )

    def get_serving(
        self, ontology: str, model_name: str, version: Optional[str] = None
    ) -> Tuple[List[str], List[str], np.ndarray, np.ndarray, Dict[str, Any]]:
        """Serve-path load: ``(entity_ids, labels, table, norms, meta)``.

        When the raw mmap layout exists (every publish writes it), ``table``
        and ``norms`` are read-only ``np.memmap`` views — zero copies, pages
        shared across worker processes.  Pre-raw snapshots fall back to the
        ``.npz`` interchange format with norms computed on the spot; either
        way the (table, norms) pair is bit-identical."""
        version = version or self.store.latest_version(ontology)
        if version is None:
            raise KeyError(f"no published versions for ontology {ontology!r}")
        meta = self.store.load_metadata(ontology, version, model_name)
        if not validate_prov(meta.get("prov", {})):
            raise ValueError(
                f"corrupt PROV metadata for {ontology}/{version}/{model_name}")
        if self.store.has_raw(ontology, version, model_name):
            table, norms, header = self.store.open_table(
                ontology, version, model_name)
            if "sorted_labels" in header:
                # publish-time autocomplete sidecar: hand it to the index
                # so per-worker load skips the per-process label re-sort
                meta = dict(meta)
                meta["sorted_labels"] = header["sorted_labels"]
            return header["ids"], header["labels"], table, norms, meta
        arrays, _ = self.store.load(ontology, version, model_name)
        emb = np.asarray(arrays["embeddings"], dtype=np.float32)
        norms = np.linalg.norm(emb, axis=1).astype(np.float32)
        return ([str(x) for x in arrays["entity_ids"]],
                [str(x) for x in arrays["labels"]], emb, norms, meta)

    def seal(self, ontology: str, version: str) -> None:
        """Mark ``version`` fully published (all models written) — the
        atomic visibility point for cross-process snapshot watchers."""
        self.store.seal(ontology, version)

    def get_params(
        self, ontology: str, model_name: str, version: Optional[str] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
        """Full param pytree + row-name vocab of a published snapshot
        (raises if the snapshot was published without params)."""
        version = version or self.store.latest_version(ontology)
        if version is None or not self.store.has_params(ontology, version, model_name):
            raise KeyError(
                f"no warm-startable params for {ontology}/{version}/{model_name}")
        return self.store.load_params(ontology, version, model_name)

    def versions(self, ontology: str) -> List[str]:
        return self.store.versions(ontology)

    def models(self, ontology: str, version: Optional[str] = None) -> List[str]:
        version = version or self.store.latest_version(ontology)
        return [] if version is None else self.store.models(ontology, version)

    def published_checksum(self, ontology: str) -> Optional[str]:
        """Checksum of the ontology release behind the latest snapshots."""
        v = self.store.latest_version(ontology)
        if v is None:
            return None
        models = self.store.models(ontology, v)
        if not models:
            return None
        _, meta = self.store.load(ontology, v, models[0])
        return meta.get("ontology_checksum")

    # --------------------------- download ------------------------------ #
    def to_json(self, ontology: str, model_name: str, version: Optional[str] = None) -> str:
        """The paper's *download* payload: {class_id: [floats...]}, at
        full float32 precision — byte-identical to what ``get-vector``
        and the gateway's paginated/streamed download serve for the same
        class (the wire-fidelity contract; no endpoint-private rounding)."""
        ids, _, emb, _ = self.get(ontology, model_name, version)
        return json.dumps({i: [float(x) for x in v] for i, v in zip(ids, emb)})
