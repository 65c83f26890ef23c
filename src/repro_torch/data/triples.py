"""Triple batching pipeline: epoch shuffling, drop-remainder padding-free
batches, host-side numpy (cheap) feeding the training step.

The port's copy of ``repro.data.triples``: the same seed gives the same
batches."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TripleLoader:
    """Infinite shuffled triple batches. Deterministic given seed."""

    def __init__(self, triples: np.ndarray, batch_size: int, seed: int = 0,
                 drop_remainder: bool = True):
        assert triples.ndim == 2 and triples.shape[1] == 3
        self.triples = np.asarray(triples, dtype=np.int32)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder

    @property
    def steps_per_epoch(self) -> int:
        m = self.triples.shape[0]
        if m == 0:
            return 0
        if self.drop_remainder:
            # a non-empty dataset smaller than one batch still yields one
            # (tiled) batch per epoch — a 0-step epoch would make __iter__
            # spin forever without ever yielding
            return max(1, m // self.batch_size)
        return -(-m // self.batch_size)

    def epoch(self) -> Iterator[np.ndarray]:
        m = self.triples.shape[0]
        if m == 0:
            raise ValueError("cannot iterate an empty TripleLoader")
        perm = self.rng.permutation(m)
        shuf = self.triples[perm]
        if self.drop_remainder and m < self.batch_size:
            reps = -(-self.batch_size // m)
            yield np.tile(shuf, (reps, 1))[: self.batch_size]
            return
        end = m - m % self.batch_size if self.drop_remainder else m
        for start in range(0, end, self.batch_size):
            batch = shuf[start : start + self.batch_size]
            if batch.shape[0] < self.batch_size:
                pad = self.batch_size - batch.shape[0]
                batch = np.concatenate([batch, shuf[:pad]], axis=0)
            yield batch

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield from self.epoch()
