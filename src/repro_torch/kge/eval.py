"""Filtered ranking evaluation: MRR, Hits@{1,3,10}.

Both-sides (head + tail corruption) evaluation against all entities, with
known true triples filtered out, matching PyKEEN's RankBasedEvaluator
(realistic/average rank for ties).  The port of ``repro.kge.eval``: the
scores come from the model's ``score_all_*`` on the params' device, the
ranks are computed on the host in numpy as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import KGEModel, Params


def _ranks(scores: np.ndarray, true_idx: np.ndarray, filter_mask: np.ndarray) -> np.ndarray:
    """Realistic rank of true_idx in each row of scores, with filtering.

    filter_mask True = known-true competitor to exclude (score set to -inf).
    """
    b = scores.shape[0]
    true_scores = scores[np.arange(b), true_idx]
    scores = np.where(filter_mask, -np.inf, scores)
    scores[np.arange(b), true_idx] = true_scores
    greater = (scores > true_scores[:, None]).sum(axis=1)
    equal = (scores == true_scores[:, None]).sum(axis=1)  # includes self
    # realistic rank = mean of optimistic and pessimistic
    return greater + (equal + 1) / 2.0


@torch.no_grad()
def rank_based_eval(
    model: KGEModel,
    params: Params,
    eval_triples: np.ndarray,        # (M, 3)
    all_triples: np.ndarray,         # (T, 3) for filtering (train+valid+test)
    batch_size: int = 128,
    ks=(1, 3, 10),
) -> Dict[str, float]:
    n = model.spec.n_entities
    dev = params["entity"].device
    known_tails: Dict[tuple, set] = {}
    known_heads: Dict[tuple, set] = {}
    for h, r, t in all_triples:
        known_tails.setdefault((int(h), int(r)), set()).add(int(t))
        known_heads.setdefault((int(r), int(t)), set()).add(int(h))

    def ids(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    ranks = []
    m = eval_triples.shape[0]
    for start in range(0, m, batch_size):
        batch = eval_triples[start : start + batch_size]
        h, r, t = batch[:, 0], batch[:, 1], batch[:, 2]

        tail_scores = model.score_all_tails(params, ids(h), ids(r)).cpu().numpy()
        mask = np.zeros((batch.shape[0], n), dtype=bool)
        for i, (hh, rr) in enumerate(zip(h, r)):
            for tt in known_tails.get((int(hh), int(rr)), ()):
                mask[i, tt] = True
        ranks.append(_ranks(tail_scores, t, mask))

        head_scores = model.score_all_heads(params, ids(r), ids(t)).cpu().numpy()
        mask = np.zeros((batch.shape[0], n), dtype=bool)
        for i, (rr, tt) in enumerate(zip(r, t)):
            for hh in known_heads.get((int(rr), int(tt)), ()):
                mask[i, hh] = True
        ranks.append(_ranks(head_scores, h, mask))

    all_ranks = np.concatenate(ranks)
    out = {
        "mrr": float(np.mean(1.0 / all_ranks)),
        "mean_rank": float(np.mean(all_ranks)),
    }
    for k in ks:
        out[f"hits@{k}"] = float(np.mean(all_ranks <= k))
    return out
