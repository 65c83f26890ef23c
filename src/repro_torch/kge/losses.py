"""Losses for KGE training (the port of ``repro.kge.losses``).

All take (pos_scores (B,), neg_scores (B, K)) with higher-is-better scores.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def margin_ranking(pos: torch.Tensor, neg: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """PyKEEN's default MarginRankingLoss (SLCWA)."""
    return torch.mean(torch.relu(margin + neg - pos[:, None]))


def nssa(pos: torch.Tensor, neg: torch.Tensor, margin: float = 9.0,
         adversarial_temperature: float = 1.0) -> torch.Tensor:
    """Self-adversarial negative sampling (RotatE paper; PyKEEN default for BoxE)."""
    w = torch.softmax(neg * adversarial_temperature, dim=-1).detach()
    neg_term = torch.sum(w * F.softplus(margin + neg), dim=-1)
    pos_term = F.softplus(-(pos + margin))
    return torch.mean(pos_term + neg_term)


def softplus_loss(pos: torch.Tensor, neg: torch.Tensor, **_) -> torch.Tensor:
    return torch.mean(F.softplus(-pos)) + torch.mean(F.softplus(neg))


def bce(pos: torch.Tensor, neg: torch.Tensor, **_) -> torch.Tensor:
    """Binary cross-entropy with logits (skip-gram w/ negative sampling form)."""
    pos_l = -F.logsigmoid(pos)
    neg_l = -F.logsigmoid(-neg)
    return torch.mean(pos_l) + torch.mean(torch.sum(neg_l, dim=-1))


LOSSES = {
    "margin": margin_ranking,
    "nssa": nssa,
    "softplus": softplus_loss,
    "bce": bce,
}


def get_loss(name: str):
    return LOSSES[name]
