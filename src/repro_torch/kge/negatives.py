"""Negative sampling: uniform head/tail corruption (PyKEEN SLCWA default).

The port of ``repro.kge.negatives``.  It returns the draws themselves,
not ``(h, r, t)`` id triples: the fused scoring kernel takes the
corrupting entity rows and the head/tail mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def corrupt(
    generator: torch.Generator,
    triples: torch.Tensor,    # (B, 3) int
    n_entities: int,
    num_negs: int,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return ``(rand_ents (B, K) int64, corrupt_head (B, K) bool)`` on
    ``generator``'s device: each positive corrupted K times, on the head
    side where ``corrupt_head`` is true and on the tail side elsewhere
    (per-sample fair coin), by uniformly drawn entities.

    ``out``, the buffers ``(rand_ents, uniform (B, K) float32,
    corrupt_head)``, takes the same draws from the same generator in place:
    a step captured in a CUDA graph reads its negatives from fixed
    tensors."""
    b = triples.shape[0]
    if out is None:
        dev = generator.device
        rand_ents = torch.randint(0, n_entities, (b, num_negs),
                                  generator=generator, device=dev)
        corrupt_head = torch.rand((b, num_negs), generator=generator,
                                  device=dev) < 0.5
        return rand_ents, corrupt_head
    rand_ents, uniform, corrupt_head = out
    torch.randint(0, n_entities, (b, num_negs), generator=generator,
                  out=rand_ents)
    torch.rand((b, num_negs), generator=generator, out=uniform)
    torch.lt(uniform, 0.5, out=corrupt_head)
    return rand_ents, corrupt_head
