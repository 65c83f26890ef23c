"""HolE (Nickel et al., 2016): score = r . corr(h, t).

corr(h, t)[k] = sum_i h[i] * t[(i + k) mod d]  — circular correlation,
computed via rFFT: corr(h, t) = irfft(conj(rfft(h)) * rfft(t)).

The port of ``repro.kge.hole``, with the reference's 1-vs-all queries
(``_tail_query``, ``_head_query``): each ``score_all_*`` is one matmul.
"""
from __future__ import annotations

import torch

from .base import KGEModel, Params, _uniform_init, gather_rows, register


def circular_correlation(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = h.shape[-1]
    fh = torch.fft.rfft(h, n=d, dim=-1)
    ft = torch.fft.rfft(t, n=d, dim=-1)
    return torch.fft.irfft(torch.conj(fh) * ft, n=d, dim=-1)


@register("hole")
class HolE(KGEModel):
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
        he = gather_rows(params["entity"], h)
        re = gather_rows(params["relation"], r)
        te = gather_rows(params["entity"], t)
        he, te = torch.broadcast_tensors(he, te)
        return torch.sum(re * circular_correlation(he, te), dim=-1)

    def score_all_tails(self, params: Params, h, r) -> torch.Tensor:
        # <r, corr(h, t)> = <q, t> with q the circular convolution of h and r
        # (derivation in _tail_query) — turns 1-vs-all into a single matmul.
        q = _tail_query(gather_rows(params["entity"], h),
                        gather_rows(params["relation"], r))
        return q @ params["entity"].T

    def score_all_heads(self, params: Params, r, t) -> torch.Tensor:
        q = _head_query(gather_rows(params["entity"], t),
                        gather_rows(params["relation"], r))
        return q @ params["entity"].T


def _tail_query(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q with <r, corr(h, t)> = <q, t> for all t.

    corr(h,t)_k = Σ_i h_i t_{(i+k) mod d}
    ⇒ score = Σ_k r_k Σ_i h_i t_{i+k} = Σ_j t_j Σ_i h_i r_{(j-i) mod d}
    ⇒ q = circular *convolution* of h and r = irfft(rfft(h)·rfft(r)).
    """
    d = h.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(h, n=d, dim=-1)
                           * torch.fft.rfft(r, n=d, dim=-1), n=d, dim=-1)


def _head_query(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q with <r, corr(h, t)> = <q, h> for all h.

    score = Σ_i h_i Σ_k r_k t_{(i+k) mod d} = <h, corr(r, t)>  (correlation of
    r with t) ⇒ q = irfft(conj(rfft(r))·rfft(t)).
    """
    d = t.shape[-1]
    return torch.fft.irfft(torch.conj(torch.fft.rfft(r, n=d, dim=-1))
                           * torch.fft.rfft(t, n=d, dim=-1), n=d, dim=-1)
