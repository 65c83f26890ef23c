"""RDF2Vec (Ristoski & Paulheim, 2016).

Two stages, as in the paper: (i) random-walk corpus over the KG
(``repro_torch.data.walks``), (ii) skip-gram with negative sampling
(word2vec SGNS) over the walk token sequences.

The model's vocabulary covers entities AND relation tokens; only the entity
rows are served. Exposed through the same KGEModel interface so the trainer,
registry and serving layer treat it uniformly — its "triples" are
(center, 0, context) pairs produced by the walker.  The port of
``repro.kge.rdf2vec``.
"""
from __future__ import annotations

import torch

from .base import KGEModel, Params, gather_rows, register


@register("rdf2vec")
class RDF2Vec(KGEModel):
    """SGNS: score(center, _, context) = <in_emb[center], out_emb[context]>.

    spec.n_entities must be the *token* vocabulary size (entities + relation
    tokens + pad); served embeddings are the first ``n_graph_entities`` rows
    of the input matrix (word2vec convention).
    """

    def param_shapes(self):
        s = self.spec
        return {"entity": (s.n_entities, s.dim),
                "context": (s.n_entities, s.dim)}

    def init(self, generator: torch.Generator) -> Params:
        s = self.spec
        scale = 1.0 / s.dim
        w_in = torch.empty((s.n_entities, s.dim), dtype=s.dtype,
                           device=generator.device)
        w_in.uniform_(-scale, scale, generator=generator)
        w_out = torch.zeros((s.n_entities, s.dim), dtype=s.dtype,
                            device=generator.device)
        return {"entity": w_in, "context": w_out}

    def score(self, params: Params, h, r, t) -> torch.Tensor:
        ce = gather_rows(params["entity"], h)
        xe = gather_rows(params["context"], t)
        ce, xe = torch.broadcast_tensors(ce, xe)
        return torch.sum(ce * xe, dim=-1)

    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        return gather_rows(params["entity"], h) @ params["context"].T

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        return gather_rows(params["context"], t) @ params["entity"].T
