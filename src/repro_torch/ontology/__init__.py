"""Ontology releases: the id-mapped graph, OBO files, release diffs and the
synthetic GO/HP generators.  The port's own copy of ``repro.ontology``
(numpy only), so the update path imports nothing of the JAX package."""
from .delta import GraphDelta
from .graph import KnowledgeGraph, TermMeta, Triple
from .obo import load_obo, parse_obo, save_obo, write_obo
from .synthetic import GO_SPEC, HP_SPEC, OntologySpec, evolve, generate, release_series

__all__ = [
    "GraphDelta", "KnowledgeGraph", "TermMeta", "Triple",
    "load_obo", "parse_obo", "save_obo", "write_obo",
    "GO_SPEC", "HP_SPEC", "OntologySpec", "evolve", "generate", "release_series",
]
