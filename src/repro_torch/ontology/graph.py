"""Triple store and id-mapped knowledge graph.

The in-memory representation every other subsystem consumes: a list of
(head, relation, tail) string triples plus dense integer id maps, convertible
to a padded CSR adjacency for vectorized random walks and to tensors for
KGE training.

The port's copy of ``repro.ontology.graph`` (numpy only): the same graph
gives the same ids, triples and ``checksum()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

Triple = Tuple[str, str, str]


@dataclasses.dataclass(frozen=True)
class TermMeta:
    """Per-class metadata mirroring an OBO [Term] stanza."""

    identifier: str
    label: str
    namespace: str = ""
    obsolete: bool = False
    definition: str = ""


@dataclasses.dataclass
class KnowledgeGraph:
    """Id-mapped triple store.

    entities / relations are sorted for determinism; ``triples`` is an
    (M, 3) int64 array of (head_id, rel_id, tail_id).
    """

    entities: List[str]
    relations: List[str]
    triples: np.ndarray  # (M, 3) int64
    terms: Dict[str, TermMeta] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.entity_to_id: Dict[str, int] = {e: i for i, e in enumerate(self.entities)}
        self.relation_to_id: Dict[str, int] = {r: i for i, r in enumerate(self.relations)}

    # ------------------------------------------------------------------ #
    @classmethod
    def from_triples(
        cls,
        triples: Iterable[Triple],
        terms: Optional[Mapping[str, TermMeta]] = None,
    ) -> "KnowledgeGraph":
        trips = list(triples)
        ents = sorted({h for h, _, _ in trips} | {t for _, _, t in trips})
        rels = sorted({r for _, r, _ in trips})
        e2i = {e: i for i, e in enumerate(ents)}
        r2i = {r: i for i, r in enumerate(rels)}
        arr = np.asarray(
            [(e2i[h], r2i[r], e2i[t]) for h, r, t in trips], dtype=np.int64
        ).reshape(-1, 3)
        return cls(ents, rels, arr, dict(terms or {}))

    # ------------------------------------------------------------------ #
    @property
    def num_entities(self) -> int:
        return len(self.entities)

    @property
    def num_relations(self) -> int:
        return len(self.relations)

    @property
    def num_triples(self) -> int:
        return int(self.triples.shape[0])

    def string_triples(self) -> List[Triple]:
        return [
            (self.entities[h], self.relations[r], self.entities[t])
            for h, r, t in self.triples
        ]

    def label_of(self, identifier: str) -> str:
        meta = self.terms.get(identifier)
        return meta.label if meta is not None else identifier

    def find_by_label(self, label: str) -> Optional[str]:
        """Resolve a textual label to a class identifier.

        Mirrors the paper's 'automatic normalization of case and whitespace'.
        """
        norm = " ".join(label.strip().lower().split())
        for ident, meta in self.terms.items():
            if " ".join(meta.label.strip().lower().split()) == norm:
                return ident
        return None

    # ------------------------------------------------------------------ #
    def checksum(self) -> str:
        """Deterministic content hash — the updater's change detector."""
        h = hashlib.sha256()
        for trip in sorted(self.string_triples()):
            h.update("\t".join(trip).encode())
            h.update(b"\n")
        for ident in sorted(self.terms):
            m = self.terms[ident]
            h.update(
                json.dumps(
                    [m.identifier, m.label, m.namespace, m.obsolete],
                    sort_keys=True,
                ).encode()
            )
        return h.hexdigest()

    # ------------------------------------------------------------------ #
    def padded_csr(self, max_degree: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense padded adjacency for vectorized random walks.

        Returns (neighbors, edge_rels, degrees):
          neighbors  (N, D) int32 — tail ids, padded with self-loops
          edge_rels  (N, D) int32 — relation ids, padded with 0
          degrees    (N,)   int32 — true out-degree (0 rows walk in place)
        """
        n = self.num_entities
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for h, r, t in self.triples:
            adj[int(h)].append((int(t), int(r)))
        deg = np.asarray([len(a) for a in adj], dtype=np.int32)
        d = int(max_degree or max(1, deg.max(initial=1)))
        nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, d))
        rels = np.zeros((n, d), dtype=np.int32)
        for i, a in enumerate(adj):
            for j, (t, r) in enumerate(a[:d]):
                nbrs[i, j] = t
                rels[i, j] = r
        return nbrs, rels, np.minimum(deg, d)

    # ------------------------------------------------------------------ #
    def split(
        self, rng: np.random.Generator, valid_frac: float = 0.05, test_frac: float = 0.05
    ) -> Tuple["KnowledgeGraph", np.ndarray, np.ndarray]:
        """Train/valid/test split over triples (ids preserved).

        Returns (train_graph_with_same_id_maps, valid_triples, test_triples).
        """
        m = self.num_triples
        perm = rng.permutation(m)
        n_valid = int(m * valid_frac)
        n_test = int(m * test_frac)
        valid = self.triples[perm[:n_valid]]
        test = self.triples[perm[n_valid : n_valid + n_test]]
        train = self.triples[perm[n_valid + n_test :]]
        kg = KnowledgeGraph(self.entities, self.relations, train, self.terms)
        return kg, valid, test
