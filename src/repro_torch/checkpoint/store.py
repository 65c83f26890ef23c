"""Versioned on-disk snapshot store: npz tensors + json metadata.

The port's copy of ``repro.checkpoint.store``: it writes and reads the
same files byte for byte, so a store published by either package serves
from the other.  The parsed-release sidecars (``graph.npz``) belong to the
update path and are not ported yet.

Layout (mirrors the paper's Zenodo deposit structure; the params
sidecars are what make post-restart warm-starts possible):
  <root>/<ontology>/<version>/<model>/embeddings.npz
  <root>/<ontology>/<version>/<model>/metadata.json     (PROV sidecar)
  <root>/<ontology>/<version>/<model>/table.f32         (raw serve layout)
  <root>/<ontology>/<version>/<model>/table.json        (raw header/vocab)
  <root>/<ontology>/<version>/<model>/params.npz        (full model params)
  <root>/<ontology>/<version>/<model>/params_vocab.json (row-name vocab)
  <root>/<ontology>/<version>/.published                (seal marker)

The raw layout is the *serve* format: little-endian float32 rows padded to
a 64-byte stride so every row starts on a cache-line boundary, followed by
the per-row L2 norms (float32), with ids/labels/geometry in the JSON
sidecar.  ``open_table`` maps it read-only with ``np.memmap``, so N worker
processes share one page-cache-resident copy.  ``embeddings.npz`` remains
the interchange/training format — compressed, self-describing, and the
only file older snapshots have.

Within a model directory the write order is table.f32 → table.json →
metadata.json (each via tmp + ``os.replace``): metadata.json is the
per-model completion marker a concurrent reader may trust.  The
version-level ``.published`` seal marks *all* models of a version complete,
so cross-process watchers never surface a half-published multi-model
version.
"""
# bioan: module-scope[BIO002]
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_DIGIT_RUN = re.compile(r"(\d+)")

RAW_TABLE = "table.f32"
RAW_HEADER = "table.json"
RAW_FORMAT = "biokg-raw-v1"
RAW_ALIGN = 64          # bytes; row stride rounds up to this
SEAL_MARKER = ".published"


def norm_label(s: str) -> str:
    """The paper's 'automatic normalization of case and whitespace' —
    canonical here so publish-time sidecars and the serving layer agree on
    one normalization (``core.serving`` imports this)."""
    return " ".join(s.strip().lower().split())


def _atomic_write_bytes(path: Path, payload: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)


def _atomic_write_text(path: Path, payload: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(payload)
    os.replace(tmp, path)


def _atomic_savez(path: Path, **arrays: np.ndarray) -> None:
    """``np.savez_compressed`` through the tmp+``os.replace`` idiom — a
    concurrent reader (another worker warm-starting, a peer computing a
    delta) must never see a half-written archive.  The tmp name keeps the
    ``.npz`` suffix so numpy doesn't append its own."""
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def version_sort_key(version: str) -> tuple:
    """Natural/date-aware version ordering key.

    Digit runs compare numerically, so '2024-10' sorts after '2024-9' and
    'v10' after 'v2' — plain lexicographic sort gets both wrong, which made
    ``latest_version`` serve a stale release.
    """
    return tuple(int(part) if part.isdigit() else part
                 for part in _DIGIT_RUN.split(version))


class SnapshotStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ #
    def _dir(self, ontology: str, version: str, model: str) -> Path:
        return self.root / ontology / version / model

    def save(
        self,
        ontology: str,
        version: str,
        model: str,
        arrays: Dict[str, np.ndarray],
        metadata: Dict[str, Any],
    ) -> Path:
        d = self._dir(ontology, version, model)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_savez(d / "embeddings.npz", **arrays)
        if {"embeddings", "entity_ids", "labels"} <= set(arrays):
            self.save_raw_table(
                ontology, version, model,
                arrays["entity_ids"], arrays["labels"], arrays["embeddings"])
        # metadata last: its presence marks the model dir complete
        _atomic_write_text(d / "metadata.json",
                           json.dumps(metadata, indent=2, sort_keys=True))
        return d

    def load(self, ontology: str, version: str, model: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        d = self._dir(ontology, version, model)
        with np.load(d / "embeddings.npz", allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        metadata = json.loads((d / "metadata.json").read_text())
        return arrays, metadata

    def load_metadata(self, ontology: str, version: str, model: str) -> Dict[str, Any]:
        """The PROV/lineage sidecar alone — no tensor load (the gateway's
        ``lineage`` endpoint reads many models per call)."""
        d = self._dir(ontology, version, model)
        return json.loads((d / "metadata.json").read_text())

    def exists(self, ontology: str, version: str, model: str) -> bool:
        return (self._dir(ontology, version, model) / "embeddings.npz").exists()

    # --------------------- raw mmap serve layout ----------------------- #
    def save_raw_table(
        self,
        ontology: str,
        version: str,
        model: str,
        entity_ids,
        labels,
        embeddings: np.ndarray,
    ) -> Path:
        """Write the zero-copy serve layout: ``table.f32`` holds the rows
        padded to a 64-byte stride followed by the per-row L2 norms, and
        ``table.json`` holds geometry + ids/labels.  Norms are computed
        here, once, in float32 — bit-identical to what ``EmbeddingIndex``
        used to compute at load time, so cosine results don't move."""
        d = self._dir(ontology, version, model)
        d.mkdir(parents=True, exist_ok=True)
        emb = np.ascontiguousarray(np.asarray(embeddings, dtype="<f4"))
        n, dim = emb.shape
        stride = (max(dim, 1) * 4 + RAW_ALIGN - 1) // RAW_ALIGN * RAW_ALIGN // 4
        buf = np.zeros((n, stride), dtype="<f4")
        buf[:, :dim] = emb
        norms = np.linalg.norm(emb, axis=1).astype("<f4")
        _atomic_write_bytes(d / RAW_TABLE, buf.tobytes() + norms.tobytes())
        header = {
            "format": RAW_FORMAT,
            "dtype": "<f4",
            "rows": int(n),
            "dim": int(dim),
            "stride_floats": int(stride),
            "align_bytes": RAW_ALIGN,
            "norms_offset_floats": int(n * stride),
            "ids": [str(x) for x in entity_ids],
            "labels": [str(x) for x in labels],
            # autocomplete sidecar: unique normalized labels, pre-sorted at
            # publish time so every worker's index load skips the O(n log n)
            # re-sort (at 100k labels, once per process per version)
            "sorted_labels": sorted({norm_label(str(x)) for x in labels}),
        }
        _atomic_write_text(d / RAW_HEADER, json.dumps(header))
        return d

    def open_table(
        self, ontology: str, version: str, model: str
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Read-only ``np.memmap`` views over the raw layout: ``(table
        [rows, dim], norms [rows], header)``.  Both views share one
        underlying map (reachable via ``.base``), so the pages are shared
        with every other process serving the same snapshot and the map is
        released when the last view is garbage-collected — at which point
        the files can be unlinked."""
        d = self._dir(ontology, version, model)
        header = json.loads((d / RAW_HEADER).read_text())
        if header.get("format") != RAW_FORMAT:
            raise ValueError(
                f"unknown raw layout {header.get('format')!r} for "
                f"{ontology}/{version}/{model}")
        n, dim, stride = header["rows"], header["dim"], header["stride_floats"]
        mm = np.memmap(d / RAW_TABLE, dtype="<f4", mode="r")
        if mm.size < n * stride + n:
            raise ValueError(
                f"truncated raw table for {ontology}/{version}/{model}: "
                f"{mm.size} floats < {n * stride + n}")
        table = mm[: n * stride].reshape(n, stride)[:, :dim]
        norms = mm[n * stride: n * stride + n]
        return table, norms, header

    def has_raw(self, ontology: str, version: str, model: str) -> bool:
        d = self._dir(ontology, version, model)
        return (d / RAW_TABLE).exists() and (d / RAW_HEADER).exists()

    # -------------------------- seal markers --------------------------- #
    def seal(self, ontology: str, version: str,
             models: Optional[List[str]] = None) -> Path:
        """Mark a version fully published (all its models written).  The
        updater calls this after the per-model publish loop; cross-process
        watchers prefer sealed versions so they never adopt a version whose
        second model is still being written."""
        d = self.root / ontology / version
        d.mkdir(parents=True, exist_ok=True)
        payload = {"models": sorted(models if models is not None
                                    else self.models(ontology, version))}
        _atomic_write_text(d / SEAL_MARKER, json.dumps(payload))
        return d / SEAL_MARKER

    def is_sealed(self, ontology: str, version: str) -> bool:
        return (self.root / ontology / version / SEAL_MARKER).exists()

    def sealed_versions(self, ontology: str) -> List[str]:
        return [v for v in self.versions(ontology)
                if self.is_sealed(ontology, v)]

    # ------------------- full-param snapshots (warm start) ------------- #
    def save_params(
        self,
        ontology: str,
        version: str,
        model: str,
        params: Dict[str, np.ndarray],
        vocab: Dict[str, List[str]],
    ) -> Path:
        """Persist the *full* param pytree (not just the served entity
        matrix) plus the row-name vocabulary for each table axis, so the
        next release can warm-start even after a process restart.

        ``vocab`` maps role -> names, e.g. {"entity": [...], "relation":
        [...]}; for rdf2vec "entity" is the walk-token vocabulary.
        """
        d = self._dir(ontology, version, model)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_savez(
            d / "params.npz",
            **{k: np.asarray(v) for k, v in params.items()})
        _atomic_write_text(
            d / "params_vocab.json",
            json.dumps({k: list(map(str, v)) for k, v in vocab.items()}))
        return d

    def load_params(
        self, ontology: str, version: str, model: str
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
        d = self._dir(ontology, version, model)
        with np.load(d / "params.npz", allow_pickle=False) as z:
            params = {k: z[k] for k in z.files}
        vocab = json.loads((d / "params_vocab.json").read_text())
        return params, vocab

    def has_params(self, ontology: str, version: str, model: str) -> bool:
        d = self._dir(ontology, version, model)
        return (d / "params.npz").exists() and (d / "params_vocab.json").exists()

    # ------------------- cached eval metrics (compare) ----------------- #
    def save_eval(self, ontology: str, version: str, model: str,
                  payload: Dict[str, Any]) -> Path:
        """Cache one model's eval metrics next to its snapshot so repeat
        ``compare`` jobs are free — the metrics of a published (immutable)
        snapshot never change, so the cache needs no invalidation."""
        d = self._dir(ontology, version, model)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_write_text(d / "eval.json",
                           json.dumps(payload, sort_keys=True))
        return d / "eval.json"

    def load_eval(self, ontology: str, version: str, model: str) -> Dict[str, Any]:
        d = self._dir(ontology, version, model)
        return json.loads((d / "eval.json").read_text())

    def has_eval(self, ontology: str, version: str, model: str) -> bool:
        return (self._dir(ontology, version, model) / "eval.json").exists()

    # ------------------------------------------------------------------ #
    def versions(self, ontology: str) -> List[str]:
        d = self.root / ontology
        if not d.exists():
            return []
        return sorted((p.name for p in d.iterdir() if p.is_dir()),
                      key=version_sort_key)

    def models(self, ontology: str, version: str) -> List[str]:
        d = self.root / ontology / version
        if not d.exists():
            return []
        return sorted(p.name for p in d.iterdir() if (p / "embeddings.npz").exists())

    def latest_version(self, ontology: str) -> Optional[str]:
        vs = self.versions(ontology)
        return vs[-1] if vs else None

    def ontologies(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())
