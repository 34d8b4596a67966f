"""Device-resident federated data store (counterpart of
``repro.data.device``, its device path with both minibatch streams).

* :class:`DeviceDataStore` — each client's shard padded to a shared
  ``[K, N_max, ...]`` block with a per-client ``lengths`` vector, resident on
  the device the simulation runs on.
* :func:`round_indices` draws round ``t``'s ``[K, L, B]`` minibatch indices
  from ``uniform(fold_in(data_key, t), (K, L, B))``, where
  ``data_key = fold_in(PRNGKey(seed), 0x0DA7A)``: bit-identical to the JAX
  stream, so both packages train on the same examples in the same order.
* The per-client stream (:func:`client_round_indices`) keys client ``k``'s
  ``[L, B]`` draw ``fold_in(fold_in(data_key, t), k)``, so any subset of
  clients is sampled without touching the others: the sparse engine gathers
  only its participants (:func:`gather_participant_rounds`).
"""
from __future__ import annotations

import math
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


def from_client_datasets(clients: Sequence[Dataset], device=None,
                         pad_to: int | None = None) -> DeviceDataStore:
    """Pack per-client shards into one store padded to the largest shard,
    or to ``pad_to`` (a cap stores of several severities share), on
    ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    counts = [int(c.y.shape[0]) for c in clients]
    if min(counts) == 0:
        raise ValueError("every client shard must be non-empty")
    cap = pad_to or max(counts)
    if cap < max(counts):
        raise ValueError(f"pad_to={cap} < largest shard ({max(counts)})")
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


# ---------------------------------------------------------------------------
# per-client stream: indices a client draws without touching the other K-1
# ---------------------------------------------------------------------------


def client_round_indices(data_key: torch.Tensor, t, client_id, length,
                         local_iters: int, batch_size: int) -> torch.Tensor:
    """``[..., L, B]`` int32 example indices of clients ``client_id`` at
    round ``t``, from ``uniform(fold_in(fold_in(data_key, t), k), (L, B))``.

    ``t``, ``client_id`` and ``length`` broadcast together (numbers or
    tensors): each lane is the JAX function for one ``(t, k)``.  Draws are
    uniform over ``[0, length)`` with replacement and never land in the
    padding."""
    key = jr.fold_in(jr.fold_in(data_key, t), client_id)
    u = jr.uniform(key, (local_iters, batch_size))
    n = torch.clamp(torch.as_tensor(length, device=u.device), min=1) \
        .to(torch.float32)[..., None, None]
    idx = torch.floor(u * n).to(torch.int32)
    return torch.minimum(idx, (n - 1.0).to(torch.int32))


def round_indices_client_stream(data_key: torch.Tensor, t,
                                lengths: torch.Tensor, local_iters: int,
                                batch_size: int) -> torch.Tensor:
    """Dense ``[K, L, B]`` form of the per-client stream: row ``k`` is
    exactly :func:`client_round_indices` for client ``k``, so gathering a
    subset of rows equals sampling that subset directly."""
    ks = torch.arange(lengths.shape[0], device=lengths.device)
    return client_round_indices(data_key, t, ks, lengths, local_iters,
                                batch_size)


def sample_round_client_stream(store: DeviceDataStore,
                               data_key: torch.Tensor, t, local_iters: int,
                               batch_size: int):
    """The dense engine's sampler on the per-client stream
    (``SimConfig.data_stream="client"``), the bit-parity reference of the
    sparse path."""
    return gather_round(store, round_indices_client_stream(
        data_key, t, store.lengths, local_iters, batch_size))


def gather_participant_rounds(store: DeviceDataStore, data_key: torch.Tensor,
                              part_idx: torch.Tensor, local_iters: int,
                              batch_size: int):
    """Batches of every round's transmitting set, participant-sized.

    ``part_idx: [T, P]`` client ids, padding lanes holding ``K``.  Returns
    ``([T, P, L, B, ...], [T, P, L, B])``: the store is touched only by a
    row gather per participant.  As in JAX, a padding lane hashes the raw
    id ``K`` (a stream no client uses) and gathers the clamped client
    ``K-1``'s rows; the sparse engine gives those lanes weight 0."""
    K = store.num_clients
    ts = torch.arange(part_idx.shape[0], device=part_idx.device)[:, None]
    kc = torch.clamp(part_idx.long(), 0, K - 1)
    bidx = client_round_indices(data_key, ts, part_idx, store.lengths[kc],
                                local_iters, batch_size).long()
    rows = kc[..., None, None]
    return store.x[rows, bidx], store.y[rows, bidx]


# ---------------------------------------------------------------------------
# footprint
# ---------------------------------------------------------------------------


def store_bytes(num_clients: int, cap: int, sample_shape: Sequence[int],
                itemsize: int = 4) -> int:
    """Exact padded-store footprint from its shape parameters, term for term
    :attr:`DeviceDataStore.nbytes`: the ``[K, N_max, ...]`` inputs, the
    ``[K, N_max]`` int32 labels and the ``[K]`` int32 lengths.  Python ints
    throughout, so a K ~ 10⁹ planning query cannot overflow."""
    row = math.prod(int(s) for s in sample_shape)
    k, cap = int(num_clients), int(cap)
    return k * cap * (row * int(itemsize) + 4) + k * 4


def estimate_store_bytes(clients: Sequence[Dataset]) -> int:
    """What :func:`from_client_datasets` would allocate for ``clients``,
    without building it."""
    counts = [int(c.y.shape[0]) for c in clients]
    x = clients[0].x
    return store_bytes(len(clients), max(counts), tuple(x.shape[1:]),
                       x.element_size())
