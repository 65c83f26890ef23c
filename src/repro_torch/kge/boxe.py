"""BoxE (Abboud et al., 2020), arity-2 specialization.

Entities: base point e + translational bump b. Relations: two boxes (one per
argument position), parameterized by center c and (positive) width w.
A point for position 1 is  p1 = e_h + b_t ; for position 2  p2 = e_t + b_h.
The distance function is the piecewise one from the paper (eq. 2-3):
inside the box, distance is scaled *down* by the width; outside, scaled up —
giving gradients that pull points into boxes.

score = -(dist(p1, box_r_1) + dist(p2, box_r_2))  (negative L2 of the
per-dimension distances, as in the paper with p=2).

The port of ``repro.kge.boxe``.  ``score_all_*`` run ``score`` over
chunks of entities, where the reference broadcasts it over (B, N, d).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import KGEModel, Params, _uniform_init, gather_rows, register
from .transe import SCORE_ALL_ELEMENTS


def _box_dist(p: torch.Tensor, center: torch.Tensor,
              width: torch.Tensor) -> torch.Tensor:
    """Per-dimension BoxE distance, then L2 over dim.

    width is the half-width κ/2 >= 0 (softplus-parameterized by the caller).
    """
    w = width + 0.5  # paper's width+1 smoothing (here half-width + 0.5)
    low = center - width
    high = center + width
    inside = (p >= low) & (p <= high)
    d_in = torch.abs(p - center) / w
    d_out = torch.abs(p - center) * w - width * (w - 1.0 / w)
    per_dim = torch.where(inside, d_in, d_out)
    return torch.linalg.vector_norm(per_dim, dim=-1)


@register("boxe")
class BoxE(KGEModel):
    def param_shapes(self):
        s = self.spec
        return {"entity": (s.n_entities, s.dim),
                "bump": (s.n_entities, s.dim),
                "center": (s.n_relations, 2, s.dim),
                "width_raw": (s.n_relations, 2, s.dim)}

    def init(self, generator: torch.Generator) -> Params:
        s = self.spec
        shapes = self.param_shapes()
        out = {name: _uniform_init(generator, shapes[name], s.dim, s.dtype)
               for name in ("entity", "bump", "center")}
        # two boxes per relation: centers + raw widths (softplus'd)
        out["width_raw"] = 0.1 * torch.randn(
            shapes["width_raw"], dtype=s.dtype, device=generator.device,
            generator=generator)
        return out

    def score(self, params: Params, h, r, t) -> torch.Tensor:
        eh, bh = gather_rows(params["entity"], h), gather_rows(params["bump"], h)
        et, bt = gather_rows(params["entity"], t), gather_rows(params["bump"], t)
        c = gather_rows(params["center"], r)          # (..., 2, d)
        w = F.softplus(gather_rows(params["width_raw"], r))   # (..., 2, d) > 0
        p1 = eh + bt
        p2 = et + bh
        d1 = _box_dist(p1, c[..., 0, :], w[..., 0, :])
        d2 = _box_dist(p2, c[..., 1, :], w[..., 1, :])
        return -(d1 + d2)

    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        return self._chunked(params, h, r, tails=True)

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        return self._chunked(params, t, r, tails=False)

    def _chunked(self, params: Params, fixed: torch.Tensor, r: torch.Tensor,
                 tails: bool) -> torch.Tensor:
        """``score`` of each (B,) query against every entity on the open
        side, over chunks of entities so each (B, chunk, d) term stays
        within SCORE_ALL_ELEMENTS."""
        b, d = fixed.shape[0], self.spec.dim
        n = self.spec.n_entities
        step = max(1, SCORE_ALL_ELEMENTS // max(1, b * d))
        out = torch.empty((b, n), dtype=params["entity"].dtype,
                          device=params["entity"].device)
        for lo in range(0, n, step):
            ids = torch.arange(lo, min(n, lo + step), device=fixed.device)
            if tails:
                s = self.score(params, fixed[:, None], r[:, None], ids[None])
            else:
                s = self.score(params, ids[None], r[:, None], fixed[:, None])
            out[:, lo:lo + step] = s
        return out
