"""Non-IID client partitioning (paper §V-A), counterpart of
``repro.data.noniid``.

"We first divide the dataset into 10 data blocks according to the label, then
further divide each data block into d·K/10 shards, and finally each client is
assigned d shards with different labels."  Smaller ``d`` ⇒ more
heterogeneous local datasets.

The assignment is numpy, seeded exactly as the JAX version seeds it: from
``randint(key, (), 0, 2**31 - 1)``, drawn with the port's threefry.  Given
the same labels, both packages therefore assign the same examples to the
same clients, in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as jr
from .synthetic import Dataset


def shard_noniid(key: torch.Tensor, ds: Dataset, num_clients: int,
                 d: int) -> list[Dataset]:
    """One Dataset per client (on ``ds``'s device), each holding ``d``
    label-shards with distinct labels where the shuffle allows."""
    C = ds.num_classes
    if (d * num_clients) % C != 0:
        raise ValueError(f"d*K must be divisible by {C} "
                         f"(got d={d}, K={num_clients})")
    shards_per_class = d * num_clients // C
    y = ds.y.cpu().numpy()
    seed = int(jr.randint(key, (), 0, 2**31 - 1))
    rng = np.random.default_rng(seed)

    shards: list[tuple[int, np.ndarray]] = []
    for c in range(C):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        for s in np.array_split(idx, shards_per_class):
            shards.append((c, s))

    # round-robin over clients, each taking the first remaining shard with a
    # label it lacks (the first remaining shard when none is left)
    rng.shuffle(shards)
    clients: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
    client_labels: list[set] = [set() for _ in range(num_clients)]
    remaining = list(shards)
    for _ in range(d):
        for k in range(num_clients):
            pick = next((i for i, (c, _) in enumerate(remaining)
                         if c not in client_labels[k]), 0)
            c, s = remaining.pop(pick)
            clients[k].append(s)
            client_labels[k].add(c)

    out = []
    for k in range(num_clients):
        if not clients[k] or sum(len(s) for s in clients[k]) == 0:
            raise ValueError(
                f"client {k} received no examples: {len(y)} examples over "
                f"{d * num_clients} shards leave some shards empty — use "
                f"fewer clients, smaller d, or more data")
        idx = np.concatenate(clients[k])
        rng.shuffle(idx)
        sel = torch.from_numpy(idx).to(ds.x.device)
        out.append(Dataset(ds.x[sel], ds.y[sel], ds.num_classes))
    return out


def heterogeneity(clients: list[Dataset]) -> float:
    """Mean pairwise total-variation distance between the clients' label
    distributions: 0 for IID, toward 1 for disjoint labels."""
    C = clients[0].num_classes
    ps = []
    for ds in clients:
        counts = np.bincount(ds.y.cpu().numpy(), minlength=C).astype(float)
        ps.append(counts / counts.sum())
    dists = [0.5 * np.abs(ps[i] - ps[j]).sum()
             for i in range(len(ps)) for j in range(i + 1, len(ps))]
    return float(np.mean(dists))
