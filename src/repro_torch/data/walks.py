"""Random-walk corpus generation for RDF2Vec (the port of
``repro.data.walks``).

Every start walks at once over a padded CSR adjacency: each step is a
dense gather plus one uniform draw per walk, on the device of the
``torch.Generator`` that draws (the reference scans a JAX key; the two
packages' draws differ for the same seed, the walks' contract does not).

A walk alternates entity and relation tokens like pyRDF2Vec:
  e0 -r0-> e1 -r1-> e2 ...
Token ids: entities keep their ids [0, N); relation r becomes N + r.
Dead ends (out-degree 0) self-loop and emit a PAD relation token (N + R),
masked out downstream.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ontology.graph import KnowledgeGraph


def relation_token(n_entities: int, rel_id):
    return n_entities + rel_id


def _walk(
    generator: torch.Generator,
    starts: torch.Tensor,      # (W,) int64 entity ids
    neighbors: torch.Tensor,   # (N, D) int64
    edge_rels: torch.Tensor,   # (N, D) int64
    degrees: torch.Tensor,     # (N,) int64
    pad_rel_token: int,
    walk_length: int,
) -> torch.Tensor:
    """Return (W, 2*walk_length+1) token sequences (entity/rel alternating)."""
    n_ent = neighbors.shape[0]
    cur = starts
    seq = torch.zeros((starts.shape[0], 2 * walk_length + 1),
                      dtype=torch.int64, device=starts.device)
    seq[:, 0] = starts
    for step in range(walk_length):
        deg = degrees[cur]
        u = torch.rand(cur.shape, generator=generator, device=cur.device)
        choice = torch.minimum((u * deg.clamp(min=1)).to(torch.int64),
                               (deg - 1).clamp(min=0))
        nxt = neighbors[cur, choice]
        rel = edge_rels[cur, choice]
        dead = deg == 0
        nxt = torch.where(dead, cur, nxt)
        rel_tok = torch.where(dead, torch.full_like(rel, pad_rel_token),
                              n_ent + rel)
        seq[:, 2 * step + 1] = rel_tok
        seq[:, 2 * step + 2] = nxt
        cur = nxt
    return seq


def token_vocab(kg: KnowledgeGraph, add_inverse: bool = True) -> list:
    """Symbolic names for the walk-token vocabulary, aligned with
    :func:`corpus`'s integer ids: entities [0, N) keep their identifiers,
    relation tokens are prefixed (``%rel%is_a``, ``%rel%is_a_inv``), and the
    PAD token is last. This is what makes rdf2vec warm-startable — two
    versions' token rows can be matched by name even though every integer
    id above an inserted entity shifts.
    """
    rels = list(kg.relations)
    if add_inverse:
        rels = rels + [r + "_inv" for r in kg.relations]
    return list(kg.entities) + [f"%rel%{r}" for r in rels] + ["%pad%"]


def corpus(
    kg: KnowledgeGraph,
    generator: torch.Generator,
    walks_per_entity: int = 10,
    walk_length: int = 4,
    add_inverse: bool = True,
) -> Tuple[np.ndarray, int, int]:
    """Generate the full walk corpus on ``generator``'s device.

    Returns (walks (W, 2L+1) int32, vocab_size, pad_token).
    Vocabulary: [0, N) entities, [N, N+R') relations (R' doubled if
    add_inverse), pad token = N + R'.
    """
    trips = kg.triples
    if add_inverse:
        inv = np.stack([trips[:, 2], trips[:, 1] + kg.num_relations, trips[:, 0]], axis=1)
        all_trips = np.concatenate([trips, inv], axis=0)
        n_rel = 2 * kg.num_relations
    else:
        all_trips = trips
        n_rel = kg.num_relations
    aug = KnowledgeGraph(
        kg.entities,
        kg.relations + [r + "_inv" for r in kg.relations] if add_inverse else kg.relations,
        all_trips,
        kg.terms,
    )
    nbrs, rels, deg = aug.padded_csr()
    n = kg.num_entities
    pad_token = n + n_rel
    dev = generator.device

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    starts = np.tile(np.arange(n, dtype=np.int64), walks_per_entity)
    walks = _walk(generator, on_dev(starts), on_dev(nbrs), on_dev(rels),
                  on_dev(deg), pad_token, walk_length)
    return walks.to(torch.int32).cpu().numpy(), pad_token + 1, pad_token


def skipgram_pairs(
    walks: np.ndarray, window: int, pad_token: int, seed: int = 0
) -> np.ndarray:
    """(P, 2) (center, context) pairs from walks, PAD-filtered, shuffled."""
    w, L = walks.shape
    pairs = []
    for off in range(1, window + 1):
        a = walks[:, :-off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        keep = (a != pad_token) & (b != pad_token)
        pairs.append(np.stack([a[keep], b[keep]], axis=1))
        pairs.append(np.stack([b[keep], a[keep]], axis=1))
    out = np.concatenate(pairs, axis=0).astype(np.int32)
    rng = np.random.default_rng(seed)
    return out[rng.permutation(out.shape[0])]
