"""Training data of the update path (the port's copy of
``repro.data.triples``; the RDF2vec walks are not ported yet)."""
from .triples import TripleLoader

__all__ = ["TripleLoader"]
