"""DistMult (Yang et al., 2015): bilinear diagonal score = <h, r, t>."""
from __future__ import annotations

import torch

from .base import KGEModel, Params, _uniform_init, register


@register("distmult")
class DistMult(KGEModel):
    kge_score_model = "distmult"

    def param_shapes(self):
        s = self.spec
        return {"entity": (s.n_entities, s.dim),
                "relation": (s.n_relations, s.dim)}

    def init(self, generator: torch.Generator) -> Params:
        s = self.spec
        ent = _uniform_init(generator, (s.n_entities, s.dim), s.dim, s.dtype)
        rel = _uniform_init(generator, (s.n_relations, s.dim), s.dim, s.dtype)
        return {"entity": ent, "relation": rel}

    def score(self, params: Params, h, r, t) -> torch.Tensor:
        he = params["entity"][h]
        re = params["relation"][r]
        te = params["entity"][t]
        return torch.sum(he * re * te, dim=-1)

    # a plain (B, d) x (d, N) product, left to torch.matmul as the
    # reference leaves it to XLA
    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        q = params["entity"][h] * params["relation"][r]         # (B, d)
        return q @ params["entity"].T                           # (B, N)

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        q = params["entity"][t] * params["relation"][r]
        return q @ params["entity"].T

    def regularizer(self, params: Params, h, r, t) -> torch.Tensor:
        # L2 on the touched rows only (sparse-friendly, like PyKEEN's LP reg)
        he = params["entity"][h]
        re = params["relation"][r]
        te = params["entity"][t]
        return torch.mean(he**2) + torch.mean(re**2) + torch.mean(te**2)
