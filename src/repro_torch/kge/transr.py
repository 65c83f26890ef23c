"""TransR (Lin et al., 2015): project entities into a per-relation space.

score = -|| h W_r + r - t W_r ||_p  with W_r a (dim, dim) relation matrix,
each projection norm-clipped to the unit ball as in PyKEEN.

The port of ``repro.kge.transr``.  A projection never gathers one
(dim, dim) matrix per id: rows are projected relation by relation (a
training step's (B, K) negatives would otherwise hold B·K matrices), and
``score_all_*`` chunk over the entities instead of materialising the
reference's (B, N, d).
"""
from __future__ import annotations

import torch

from .base import KGEModel, Params, _uniform_init, gather_rows, register
from .transe import SCORE_ALL_ELEMENTS


def _clip(p: torch.Tensor) -> torch.Tensor:
    """Rows with norm > 1 scaled back to norm 1."""
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True),
                           min=1.0)


@register("transr")
class TransR(KGEModel):
    def param_shapes(self):
        s = self.spec
        return {"entity": (s.n_entities, s.dim),
                "relation": (s.n_relations, s.dim),
                "proj": (s.n_relations, s.dim, s.dim)}

    def init(self, generator: torch.Generator) -> Params:
        s = self.spec
        ent = _uniform_init(generator, (s.n_entities, s.dim), s.dim, s.dtype)
        rel = _uniform_init(generator, (s.n_relations, s.dim), s.dim, s.dtype)
        # identity-ish init keeps early training close to TransE
        noise = torch.randn((s.n_relations, s.dim, s.dim), dtype=s.dtype,
                            device=generator.device, generator=generator)
        eye = torch.eye(s.dim, dtype=s.dtype, device=generator.device)
        return {"entity": ent, "relation": rel,
                "proj": eye[None] + 0.01 * noise}

    def _dist(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.p_norm == 1:
            return torch.sum(torch.abs(x), dim=-1)
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)

    def _project(self, e: torch.Tensor, r: torch.Tensor,
                 proj: torch.Tensor) -> torch.Tensor:
        """Rows ``e (..., d)`` through their relations' matrices ``W_r``
        (``r`` broadcast to ``e``'s leading shape), norm-clipped: every
        row goes through every relation's matrix and keeps its own (the
        workloads' ontologies have 1-3 relations; no host sync)."""
        d = e.shape[-1]
        flat = e.reshape(-1, d)
        rf = r.expand(e.shape[:-1]).reshape(-1)
        p = torch.zeros_like(flat)
        for u in range(proj.shape[0]):
            p = torch.where((rf == u)[:, None], flat @ proj[u], p)
        return _clip(p).reshape(e.shape)

    def score(self, params: Params, h, r, t) -> torch.Tensor:
        h, r, t = torch.broadcast_tensors(h, r, t)
        he = gather_rows(params["entity"], h)
        te = gather_rows(params["entity"], t)
        re = gather_rows(params["relation"], r)
        hp = self._project(he, r, params["proj"])
        tp = self._project(te, r, params["proj"])
        return -self._dist(hp + re - tp)

    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        w = gather_rows(params["proj"], r)                      # (B, d, d)
        hp = _clip(torch.einsum("bd,bde->be",
                                gather_rows(params["entity"], h), w))
        q = hp + gather_rows(params["relation"], r)             # (B, d)
        return self._chunked(q, w, params["entity"], tails=True)

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        w = gather_rows(params["proj"], r)
        tp = _clip(torch.einsum("bd,bde->be",
                                gather_rows(params["entity"], t), w))
        q = tp - gather_rows(params["relation"], r)             # h_p ~ t_p - r
        return self._chunked(q, w, params["entity"], tails=False)

    def _chunked(self, q: torch.Tensor, w: torch.Tensor, ent: torch.Tensor,
                 tails: bool) -> torch.Tensor:
        """-dist between each query and every entity projected through
        the query's matrix, over chunks of entity rows so the (B, chunk,
        d) projection stays within SCORE_ALL_ELEMENTS; the difference is
        ``q - p`` for tails and ``p - q`` for heads, as in the reference."""
        b, d = q.shape
        n = ent.shape[0]
        step = max(1, SCORE_ALL_ELEMENTS // max(1, b * d))
        out = torch.empty((b, n), dtype=q.dtype, device=q.device)
        for lo in range(0, n, step):
            allp = _clip(torch.einsum("nd,bde->bne", ent[lo:lo + step], w))
            diff = (q[:, None, :] - allp) if tails else (allp - q[:, None, :])
            out[:, lo:lo + step] = -self._dist(diff)
        return out

    def constrain(self, params: Params) -> Params:
        """Entity rows with norm > 1 scaled back to norm 1, in place."""
        with torch.no_grad():
            ent = params["entity"]
            norm = torch.linalg.norm(ent, dim=-1, keepdim=True)
            ent.div_(torch.clamp(norm, min=1.0))
        return params
