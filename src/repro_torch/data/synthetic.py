"""Deterministic synthetic datasets (counterpart of ``repro.data.synthetic``).

The container is offline, so MNIST and CIFAR-10 cannot be downloaded:
``make_mnist_like`` builds a procedural stand-in with the same label
structure (784-dim inputs, 10 classes, 60,000/10,000 examples by default)
and ``make_cifar_like`` one of 32×32×3 NHWC inputs (50,000/10,000), both
from class prototypes, per-class low-rank manifolds and noise, all drawn
with the port's threefry (:mod:`repro_torch.random`).  Labels are bit-identical to the JAX
generator's; the inputs agree to float32 rounding (``normal`` goes through
``erfinv``, which differs by a few ulps between the frameworks).
``make_token_stream`` (the LLM's synthetic corpus) is integer draws only,
so its tokens are the JAX generator's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as jr
from .. import resolve_device


class Dataset(NamedTuple):
    x: torch.Tensor       # [N, ...] inputs
    y: torch.Tensor       # [N] int32 labels
    num_classes: int


def _cluster_classification(key, n, dim, num_classes, noise, device):
    """Class prototypes + per-class low-rank manifolds + noise."""
    k1, k2, k3, k4, k5 = jr.split(key, 5)
    protos = jr.normal(k1, (num_classes, dim), device=device) * 1.2
    rank = max(dim // 16, 4)
    manifolds = jr.normal(k2, (num_classes, rank, dim), device=device) * 0.6
    y = jr.randint(k3, (n,), 0, num_classes, device=device)
    coeff = jr.normal(k4, (n, rank), device=device)
    # Σ_r coeff[n, r]·manifolds[y_n, r, :], one product per class: the
    # gathered [n, rank, dim] operand would be ~11 GB at MNIST's full size
    # and ~141 GB at CIFAR's
    x = protos[y]
    for c in range(num_classes):
        idx = torch.nonzero(y == c).squeeze(1)
        x[idx] += coeff[idx] @ manifolds[c]
    return x + noise * jr.normal(k5, (n, dim), device=device), y


def make_mnist_like(key: torch.Tensor, n_train: int = 60_000,
                    n_test: int = 10_000, noise: float = 0.9,
                    device=None) -> tuple[Dataset, Dataset]:
    """``(train, test)`` on ``device`` (``None`` means the card)."""
    dim, num_classes = 784, 10
    x, y = _cluster_classification(key, n_train + n_test, dim, num_classes,
                                   noise, resolve_device(device))
    x = torch.tanh(x)   # bounded like normalized pixels
    return (Dataset(x[:n_train], y[:n_train], num_classes),
            Dataset(x[n_train:], y[n_train:], num_classes))


def make_cifar_like(key: torch.Tensor, n_train: int = 50_000,
                    n_test: int = 10_000, noise: float = 1.1,
                    device=None) -> tuple[Dataset, Dataset]:
    """``(train, test)`` of ``[N, 32, 32, 3]`` (NHWC) inputs on ``device``
    (``None`` means the card)."""
    dim, num_classes = 32 * 32 * 3, 10
    x, y = _cluster_classification(key, n_train + n_test, dim, num_classes,
                                   noise, resolve_device(device))
    x = torch.tanh(x).reshape(-1, 32, 32, 3)
    return (Dataset(x[:n_train], y[:n_train], num_classes),
            Dataset(x[n_train:], y[n_train:], num_classes))


def make_token_stream(key: torch.Tensor, n_seqs: int, seq_len: int,
                      vocab: int, device=None) -> Dataset:
    """Synthetic LM data: per-sequence Markov-ish token chains, so that a
    language model has learnable structure (bigram transitions):
    ``next = (prev · a + 7 + noise) mod vocab`` with ``a`` drawn once in
    [3, 17) and the noise in ``[0, max(vocab // 50, 2))``, one key a step
    from ``split(key, seq_len − 1)``.  Tokens ``[n_seqs, seq_len]`` int32
    on ``device`` (``None`` means the card), with all-zero labels."""
    device = resolve_device(device)
    key = key.to(device)
    k1, k2 = jr.split(key)
    a = int(jr.randint(k1, (), 3, 17))
    tok = jr.randint(k2, (n_seqs,), 0, vocab).to(torch.int64)
    cols = [tok]
    for k in jr.split(key, seq_len - 1):
        noise = jr.randint(k, (n_seqs,), 0, max(vocab // 50, 2))
        tok = (tok * a + 7 + noise) % vocab
        cols.append(tok)
    toks = torch.stack(cols, dim=1).to(torch.int32)
    return Dataset(toks, torch.zeros(n_seqs, dtype=torch.int32,
                                     device=device), vocab)
