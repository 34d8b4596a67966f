"""Deterministic host batching (counterpart of ``repro.data.pipeline``).

Each client of the prestack data path owns one :class:`BatchIterator` over
its shard, shuffled by numpy's ``default_rng(seed)``: the same generator,
seeded the same way, as the JAX package's, so the two draw the same
batches in the same order.  :func:`client_batches` stacks one batch per
client into ``([K, B, ...], [K, B])``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .synthetic import Dataset


@dataclasses.dataclass
class BatchIterator:
    """Infinite shuffled batches over a dataset, drawn on the host (CPU
    tensors)."""

    ds: Dataset
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._x = self.ds.x.cpu()
        self._y = self.ds.y.cpu()
        self._order = self._rng.permutation(len(self._y))
        self._pos = 0

    def __next__(self):
        n = len(self._y)
        if self.batch_size >= n:
            return self._x, self._y
        if self._pos + self.batch_size > n:
            self._order = self._rng.permutation(n)
            self._pos = 0
        sel = torch.from_numpy(self._order[self._pos:
                                           self._pos + self.batch_size])
        self._pos += self.batch_size
        return self._x[sel], self._y[sel]

    def __iter__(self):
        return self


def client_batches(iters: list[BatchIterator]):
    """Stack one batch per client: ``([K, B, ...], [K, B])``."""
    xs, ys = zip(*(next(it) for it in iters))
    return torch.stack(xs), torch.stack(ys)
