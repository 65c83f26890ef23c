"""Graph diffs between ontology releases — the incremental-update contract.

Consecutive GO/HP releases overlap almost entirely (Know2BIO reports >95%
entity survival month-over-month), so the updater should not pay full
retraining for a release that only adds a handful of terms. ``GraphDelta``
is the exact diff between two ``KnowledgeGraph`` versions that the update
policy consumes:

  * added / removed / relabeled entities (string identifiers),
  * added / removed relations,
  * added / removed string triples,
  * ``churn_fraction`` — the fraction of the combined entity universe that
    was touched by any of the above. The updater goes *incremental* when
    churn is below its threshold and *full* otherwise.

The delta is purely set-based over string identifiers, so it is stable
across the integer-id remapping that happens when entities are inserted
into the sorted entity list (an added term shifts every id above it; the
delta is unaffected).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

from .graph import KnowledgeGraph, Triple


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """Exact diff between two releases of one ontology."""

    added_entities: List[str]
    removed_entities: List[str]
    relabeled_entities: List[str]
    added_relations: List[str]
    removed_relations: List[str]
    added_triples: List[Triple]
    removed_triples: List[Triple]
    #: |old entities ∪ new entities| — churn denominator
    n_universe: int

    # ------------------------------------------------------------------ #
    @classmethod
    def compute(cls, old: KnowledgeGraph, new: KnowledgeGraph) -> "GraphDelta":
        old_ents, new_ents = set(old.entities), set(new.entities)
        old_rels, new_rels = set(old.relations), set(new.relations)
        old_trips, new_trips = set(old.string_triples()), set(new.string_triples())

        relabeled = sorted(
            e for e in old_ents & new_ents
            if e in old.terms and e in new.terms
            and old.terms[e].label != new.terms[e].label
        )
        return cls(
            added_entities=sorted(new_ents - old_ents),
            removed_entities=sorted(old_ents - new_ents),
            relabeled_entities=relabeled,
            added_relations=sorted(new_rels - old_rels),
            removed_relations=sorted(old_rels - new_rels),
            added_triples=sorted(new_trips - old_trips),
            removed_triples=sorted(old_trips - new_trips),
            n_universe=len(old_ents | new_ents),
        )

    # ------------------------------------------------------------------ #
    @functools.cached_property
    def touched_entities(self) -> List[str]:
        """Every entity affected by the diff: added, removed, relabeled, or
        an endpoint of an added/removed triple. Cached — the delta is
        immutable and plan/stats/churn all consume this set."""
        touched = set(self.added_entities) | set(self.removed_entities)
        touched |= set(self.relabeled_entities)
        for h, _, t in self.added_triples:
            touched.add(h)
            touched.add(t)
        for h, _, t in self.removed_triples:
            touched.add(h)
            touched.add(t)
        return sorted(touched)

    @property
    def churn_fraction(self) -> float:
        """|touched entities| / |entity universe| — the policy signal."""
        if self.n_universe == 0:
            return 0.0
        return len(self.touched_entities) / self.n_universe

    @property
    def is_empty(self) -> bool:
        return not (self.added_entities or self.removed_entities
                    or self.relabeled_entities or self.added_relations
                    or self.removed_relations or self.added_triples
                    or self.removed_triples)

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        """Compact JSON-able summary for UpdateReport / lineage metadata."""
        return {
            "added_entities": len(self.added_entities),
            "removed_entities": len(self.removed_entities),
            "relabeled_entities": len(self.relabeled_entities),
            "added_relations": len(self.added_relations),
            "removed_relations": len(self.removed_relations),
            "added_triples": len(self.added_triples),
            "removed_triples": len(self.removed_triples),
            "touched_entities": len(self.touched_entities),
            "n_universe": self.n_universe,
            "churn_fraction": round(self.churn_fraction, 6),
        }
