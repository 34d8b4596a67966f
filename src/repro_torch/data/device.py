"""Device-resident federated data store (counterpart of
``repro.data.device``, its device path with the per-round stream).

* :class:`DeviceDataStore` — each client's shard padded to a shared
  ``[K, N_max, ...]`` block with a per-client ``lengths`` vector, resident on
  the device the simulation runs on.
* :func:`round_indices` draws round ``t``'s ``[K, L, B]`` minibatch indices
  from ``uniform(fold_in(data_key, t), (K, L, B))``, where
  ``data_key = fold_in(PRNGKey(seed), 0x0DA7A)``: bit-identical to the JAX
  stream, so both packages train on the same examples in the same order.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import random as jr
from .. import resolve_device
from .synthetic import Dataset

#: fold_in tag separating the minibatch stream from the participation stream.
DATA_STREAM = 0x0DA7A


class DeviceDataStore(NamedTuple):
    """Padded per-client shards: ``x[k, :lengths[k]]`` are client k's
    examples; rows beyond ``lengths[k]`` are zeros and never sampled."""

    x: torch.Tensor        # [K, N_max, ...] inputs, zero-padded
    y: torch.Tensor        # [K, N_max] int32 labels, zero-padded
    lengths: torch.Tensor  # [K] int32 valid example counts

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.x, self.y, self.lengths))


def data_stream_key(seed_or_key, device=None) -> torch.Tensor:
    """Minibatch-stream key for a simulation seed (or an existing key)."""
    key = (seed_or_key if isinstance(seed_or_key, torch.Tensor)
           else jr.PRNGKey(seed_or_key, device=device))
    return jr.fold_in(key, DATA_STREAM)


def from_client_datasets(clients: Sequence[Dataset],
                         device=None) -> DeviceDataStore:
    """Pack per-client shards into one store padded to the largest shard,
    on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    counts = [int(c.y.shape[0]) for c in clients]
    if min(counts) == 0:
        raise ValueError("every client shard must be non-empty")
    cap = max(counts)
    sample = tuple(clients[0].x.shape[1:])
    x = torch.zeros((len(clients), cap) + sample, dtype=clients[0].x.dtype,
                    device=device)
    y = torch.zeros((len(clients), cap), dtype=torch.int32, device=device)
    for k, c in enumerate(clients):
        x[k, :counts[k]] = c.x.to(device)
        y[k, :counts[k]] = c.y.to(device=device, dtype=torch.int32)
    return DeviceDataStore(x, y, torch.tensor(counts, dtype=torch.int32,
                                              device=device))


def round_indices(data_key: torch.Tensor, t, lengths: torch.Tensor,
                  local_iters: int, batch_size: int) -> torch.Tensor:
    """``[K, L, B]`` int32 example indices for round ``t`` from
    ``fold_in(data_key, t)`` only — uniform over each client's valid rows,
    with replacement."""
    K = lengths.shape[0]
    u = jr.uniform(jr.fold_in(data_key, t), (K, local_iters, batch_size),
                   device=lengths.device)
    n = torch.clamp(lengths, min=1).to(torch.float32)[:, None, None]
    idx = torch.floor(u * n).to(torch.int32)
    return torch.minimum(idx, (n - 1.0).to(torch.int32))


def gather_round(store: DeviceDataStore, idx: torch.Tensor):
    """``([K, L, B, ...], [K, L, B])`` batches for index blocks
    ``idx: [K, L, B]``."""
    rows = torch.arange(store.num_clients, device=idx.device)[:, None, None]
    idx = idx.long()
    return store.x[rows, idx], store.y[rows, idx]


def sample_round(store: DeviceDataStore, data_key: torch.Tensor, t,
                 local_iters: int, batch_size: int):
    """One round's stacked client batches, sampled on the store's device."""
    return gather_round(store, round_indices(data_key, t, store.lengths,
                                             local_iters, batch_size))
