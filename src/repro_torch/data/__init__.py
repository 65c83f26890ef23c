"""Training data of the update path (the port's copy of ``repro.data``):
the triple loader and the RDF2vec walk corpus."""
from .triples import TripleLoader
from .walks import corpus, relation_token, skipgram_pairs, token_vocab

__all__ = ["TripleLoader", "corpus", "relation_token", "skipgram_pairs",
           "token_vocab"]
