"""TransE (Bordes et al., 2013): score = -||h + r - t||_p."""
from __future__ import annotations

import torch

from .base import KGEModel, Params, _uniform_init, register

#: (B, chunk, d) elements the ``score_all_*`` hold at once: the reference
#: materialises (B, N, d), 4.1 GB at eval's B = 128 and N = 40,000
SCORE_ALL_ELEMENTS = 1 << 24


@register("transe")
class TransE(KGEModel):
    @property
    def kge_score_model(self) -> str:
        return "transe_l1" if self.spec.p_norm == 1 else "transe_l2"

    def param_shapes(self):
        s = self.spec
        return {"entity": (s.n_entities, s.dim),
                "relation": (s.n_relations, s.dim)}

    def init(self, generator: torch.Generator) -> Params:
        s = self.spec
        ent = _uniform_init(generator, (s.n_entities, s.dim), s.dim, s.dtype)
        rel = _uniform_init(generator, (s.n_relations, s.dim), s.dim, s.dtype)
        rel = rel / (torch.linalg.norm(rel, dim=-1, keepdim=True) + 1e-12)
        return {"entity": ent, "relation": rel}

    def _dist(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.p_norm == 1:
            return torch.sum(torch.abs(x), dim=-1)
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)

    def score(self, params: Params, h, r, t) -> torch.Tensor:
        he = params["entity"][h]
        re = params["relation"][r]
        te = params["entity"][t]
        return -self._dist(he + re - te)

    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        q = params["entity"][h] + params["relation"][r]       # (B, d)
        return self._chunked(q, params["entity"], tails=True)

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        # h + r - t = h - (t - r): distance between each entity and q
        q = params["entity"][t] - params["relation"][r]       # (B, d)
        return self._chunked(q, params["entity"], tails=False)

    def _chunked(self, q: torch.Tensor, ent: torch.Tensor,
                 tails: bool) -> torch.Tensor:
        """-dist over every entity row, in chunks of rows so the (B, chunk,
        d) difference stays within SCORE_ALL_ELEMENTS; the difference is
        ``q - e`` for tails and ``e - q`` for heads, as in the reference."""
        b, d = q.shape
        n = ent.shape[0]
        step = max(1, SCORE_ALL_ELEMENTS // max(1, b * d))
        out = torch.empty((b, n), dtype=q.dtype, device=q.device)
        for lo in range(0, n, step):
            e = ent[lo:lo + step]
            diff = (q[:, None, :] - e[None]) if tails else (e[None] - q[:, None, :])
            out[:, lo:lo + step] = -self._dist(diff)
        return out

    def constrain(self, params: Params) -> Params:
        """Entity rows with norm > 1 scaled back to norm 1, in place."""
        with torch.no_grad():
            ent = params["entity"]
            norm = torch.linalg.norm(ent, dim=-1, keepdim=True)
            ent.div_(torch.clamp(norm, min=1.0))
        return params
